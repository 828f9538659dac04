// K1 and K3 redesigned for NVIDIA Hopper: the single-RHS products on the
// row-packed form, y = diag(out_scale) * Q * (in_scale o x).  K2 and K4,
// the multi-RHS products on the same form, follow at the end of the file
// (row_spmm_kernel): column j of theirs is this kernel's on column j.
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
// int8, or int4 as nibble pairs: a vector's 8 values in one 32-bit word,
// slot j in bits 4j..4j+3), columns as uint16 when the matrix has at most
// 65536 of them, int32 otherwise; vec_off[r] the first vector of packed
// row r, row_map[r] its original row.  Inside a row, vectors are interleaved at pack time so that
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
//     (exact), not I2F, which runs at a fraction of the FMA rate; int4 the
//     same way, a nibble at a time from one 4-byte load per vector (the
//     Pallas kernels' packed4 panels, spmv_pallas.py:64-69: about 2.5 bytes
//     a stored entry with uint16 indices, against 3 for int8);
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

// Two int4 values in one byte, low nibble first (two's complement): the
// storage unit of a packed4 form.
struct Nib4 {
  uint8_t b;
};

// int4 v -> float exactly: the nibble v ^ 8 = v + 8 placed in the mantissa
// of 2^23, minus 2^23 + 8.  w holds the vector's 8 nibbles, each already
// xor-ed with 8.
__device__ __forceinline__ float nibble(unsigned w, int j) {
  return __uint_as_float(0x4B000000u | ((w >> (4 * j)) & 0xFu)) - 8388616.0f;
}

template <>
struct Vals<Nib4> {
  static constexpr int kPer = V / 2;  // storage units of one vector
  __device__ __forceinline__ static void load(const Nib4* p, float f[V]) {
    const unsigned w =
        __ldg(reinterpret_cast<const unsigned*>(p)) ^ 0x88888888u;
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = nibble(w, j);
  }
};

template <>
struct Vals<int8_t> {
  static constexpr int kPer = V;
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
  static constexpr int kPer = V;
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
  static constexpr int kPer = V;
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
  Vals<T>::load(vals + k * Vals<T>::kPer, a);
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
        Vals<T>::load(vals + static_cast<int64_t>(k) * Vals<T>::kPer, a);
        Cols<I>::load(cols + static_cast<int64_t>(k) * V, ca);
        Vals<T>::load(vals + static_cast<int64_t>(k + lanes) * Vals<T>::kPer,
                      b);
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

// C entry point, loaded with ctypes.  dtype: 0 float32, 1 bfloat16, 2 int8,
// 3 int4 (nibble pairs);
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
    case 3:
      err = launch_index<Nib4>(wide, xs != 0, a);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// K2 and K4 redesigned: the multi-RHS products on the same form,
//   K2: Y = diag(s) Q X on the form of the forward panel (out_scale = s);
//   K4: Y = diag(out_scale) Q^T (s o U) on the form of the transpose
//       (in_scale = s, gathered beside U);
// for X (ncols, R) read through its element strides and Y (rows, R) written
// through its own (the caller's slab, in place).  They replace the Pallas
// kernels _bucket_matmat (K2, wrapper bucketed_bsr_matmat) and
// _bucket_rmatmat (K4, wrapper bucketed_bsr_rmatmat) of
// hybrid_gmres_tpu/ops/spmv_pallas.py on every multi-RHS application.
//
// The same walk as row_spmv_kernel (the same lanes per row, the same
// persistent blocks over contiguous row runs), but each stored entry and its
// index are read and converted once per tile of RT = 8 right-hand sides and
// used for RT FMAs.  One launch per call: blockIdx.y walks the tiles (each
// further tile reads the form again), the last one masked.
//
// What bounds it: bytes.  The form is 3-5 bytes per nonzero, the RT gathered
// floats of an entry one 32-byte sector when X is interleaved; at CT n=128
// the gathers (about 810 MB on A) come from L1/L2, the form (82 MB) from HBM.
// The gathered tile is read one of two ways (GATHER):
//   STRIDED: eight 4-byte loads through X's strides (any layout, any R);
//   PACKED:  one or two 16-byte loads from a row-major X (rows on 16-byte
//            boundaries, each readable up to R rounded up to a multiple of
//            4: the caller checks its storage); for K4 the caller has
//            multiplied the scale into its interleaving copy, so K2 and K4
//            run the same instantiation.
// Blocks of 1024 threads or of 256, four to a multiprocessor: the same 64
// registers a thread; which is faster depends on the lanes per row and the
// gather (the caller's choice, measured on the CT forms).
//
// Bits: for each column, the sum is K1's (K3's) exactly: each lane adds its
// vectors in ascending order, slots in order, one fmaf per entry; the lanes
// of a warp combine through the same xor tree (a halving butterfly that
// trades half of the RT values at each of its first three steps: every
// addition still adds the same two operands, and a + b == b + a); the warps
// of a row in warp order.  So column j of row_spmm equals row_spmv on
// column j bit for bit, in every GATHER and across runs.  No atomics.

namespace {

constexpr int RT = 8;
enum Gather { STRIDED = 0, PACKED = 1 };

// A vector's values and indices kept as loaded (8 int8 values in two words,
// 8 uint16 indices in four) and unpacked a slot at a time, with the
// conversions of Vals and Cols: fewer registers live across the gathers.
template <typename T>
struct RawVals;

template <>
struct RawVals<Nib4> {
  static constexpr int kPer = V / 2;
  unsigned w;
  __device__ __forceinline__ void load(const Nib4* p) {
    w = __ldg(reinterpret_cast<const unsigned*>(p)) ^ 0x88888888u;
  }
  __device__ __forceinline__ float get(int j) const { return nibble(w, j); }
};

template <>
struct RawVals<int8_t> {
  static constexpr int kPer = V;
  uint2 w;
  __device__ __forceinline__ void load(const int8_t* p) {
    w = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ float get(int j) const {
    const unsigned u = (j < 4 ? w.x : w.y) ^ 0x80808080u;
    return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u + (j & 3))) -
           8388736.0f;
  }
};

template <>
struct RawVals<__nv_bfloat16> {
  static constexpr int kPer = V;
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float get(int j) const {
    const unsigned u = j < 2 ? w.x : j < 4 ? w.y : j < 6 ? w.z : w.w;
    return __uint_as_float((j & 1) ? (u & 0xffff0000u) : (u << 16));
  }
};

template <>
struct RawVals<float> {
  static constexpr int kPer = V;
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ float get(int j) const {
    const float4& h = j < 4 ? a : b;
    const int k = j & 3;
    return k == 0 ? h.x : k == 1 ? h.y : k == 2 ? h.z : h.w;
  }
};

template <typename I>
struct RawCols;

template <>
struct RawCols<uint16_t> {
  uint4 w;
  __device__ __forceinline__ void load(const uint16_t* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ int get(int j) const {
    const unsigned u = j < 2 ? w.x : j < 4 ? w.y : j < 6 ? w.z : w.w;
    return static_cast<int>((j & 1) ? (u >> 16) : (u & 0xffffu));
  }
};

template <>
struct RawCols<int> {
  int4 a, b;
  __device__ __forceinline__ void load(const int* p) {
    a = __ldg(reinterpret_cast<const int4*>(p));
    b = __ldg(reinterpret_cast<const int4*>(p) + 1);
  }
  __device__ __forceinline__ int get(int j) const {
    const int4& h = j < 4 ? a : b;
    const int k = j & 3;
    return k == 0 ? h.x : k == 1 ? h.y : k == 2 ? h.z : h.w;
  }
};

// The RT values of column c of the tile: X[c, 0:RT] (times in_scale[c] for
// K4's strided gather; the packed gather's input holds the product), zero
// past the tile's width w.
template <bool K4, int GATHER>
__device__ __forceinline__ void gather_tile(const float* __restrict__ X,
                                            int64_t sx0, int64_t sx1,
                                            const float* __restrict__ in_scale,
                                            int c, int w, float xv[RT]) {
  if (GATHER == PACKED) {
    const float4* p = reinterpret_cast<const float4*>(X + c * sx0);
    const float4 lo = __ldg(p);
    const float4 hi = w > 4 ? __ldg(p + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
    xv[0] = lo.x; xv[1] = lo.y; xv[2] = lo.z; xv[3] = lo.w;
    xv[4] = hi.x; xv[5] = hi.y; xv[6] = hi.z; xv[7] = hi.w;
  } else {
    const float* p = X + c * sx0;
#pragma unroll
    for (int t = 0; t < RT; ++t, p += sx1) xv[t] = t < w ? __ldg(p) : 0.0f;
  }
  if (K4 && GATHER == STRIDED) {
    const float s = __ldg(in_scale + c);
#pragma unroll
    for (int t = 0; t < RT; ++t) xv[t] = xv[t] * s;
  }
}

// One step of the butterfly: lanes whose bit o is set keep the upper half of
// their H values, the others the lower half; each adds its partner's value of
// the same column.
template <int H>
__device__ __forceinline__ void halve(float acc[RT], int lane, int o,
                                      int& base) {
  const bool up = (lane & o) != 0;
#pragma unroll
  for (int t = 0; t < H / 2; ++t) {
    const float send = up ? acc[t] : acc[t + H / 2];
    const float keep = up ? acc[t + H / 2] : acc[t];
    acc[t] = keep + __shfl_xor_sync(FULL, send, o);
  }
  if (up) base += H / 2;
}

// The end of a row's product: the lanes' RT sums of a packed row (valid: a
// row of the block's pass) reduced by the xor tree of row_spmv_kernel,
// column by column, as a butterfly (afterwards a lane holds `held` columns
// from `base` on), then scaled and written to Y's row i (the original row);
// a row over several warps adds their sums in warp order (`part`, one row of
// RT floats a warp).  Every thread of the block calls it (its barriers).
__device__ __forceinline__ void write_row(float acc[RT], float (*part)[RT],
                                          int lanes, bool valid, int i,
                                          const float* __restrict__ out_scale,
                                          float* __restrict__ Y, int64_t sy0,
                                          int64_t sy1, int w) {
  const int tid = threadIdx.x;
  const int l = tid % lanes;
  const int warp_lanes = lanes < 32 ? lanes : 32;
  // lanes that hold copies of the same columns after the butterfly
  const int dup_mask = (warp_lanes >= 8 ? warp_lanes / 8 : 1) - 1;
  int o = warp_lanes >> 1;
  int base = 0;
  int held = RT;
  if (o > 0) { halve<8>(acc, tid, o, base); held = 4; o >>= 1; }
  if (o > 0) { halve<4>(acc, tid, o, base); held = 2; o >>= 1; }
  if (o > 0) { halve<2>(acc, tid, o, base); held = 1; o >>= 1; }
  for (; o > 0; o >>= 1) acc[0] += __shfl_xor_sync(FULL, acc[0], o);
  if (lanes <= 32) {
    if (valid && (l & dup_mask) == 0) {
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        if (t < held && base + t < w) {
          Y[i * sy0 + (base + t) * sy1] =
              out_scale != nullptr ? out_scale[i] * acc[t] : acc[t];
        }
      }
    }
  } else {  // a row over several warps: their sums in warp order
    if ((tid & dup_mask) == 0) {
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        if (t < held) part[tid >> 5][base + t] = acc[t];
      }
    }
    __syncthreads();
    if (l < w && valid) {   // the row's first warp, a column a lane
      float total = part[tid >> 5][l];
      for (int ww = 1; ww < lanes / 32; ++ww) {
        total += part[(tid >> 5) + ww][l];
      }
      Y[i * sy0 + l * sy1] =
          out_scale != nullptr ? out_scale[i] * total : total;
    }
    __syncthreads();
  }
}

// NT threads per block, 1024 / NT blocks per multiprocessor: at most 64
// registers a thread either way.  K4: the strided gather multiplies in_scale
// in (the packed gather's K4 runs as K2 on the scaled copy).
template <typename T, typename I, bool K4, int GATHER, int NT>
__global__ void __launch_bounds__(NT, 1024 / NT)
    row_spmm_kernel(const T* __restrict__ vals, const I* __restrict__ cols,
                    const int* __restrict__ vec_off,
                    const int* __restrict__ row_map,
                    const float* __restrict__ X, int64_t sx0, int64_t sx1,
                    const float* __restrict__ in_scale,
                    const float* __restrict__ out_scale,
                    float* __restrict__ Y, int64_t sy0, int64_t sy1,
                    int rows, int R, int lanes, int row_blocks) {
  __shared__ float part[NT / 32][RT];
  const int tid = threadIdx.x;
  const int c0 = static_cast<int>(blockIdx.y) * RT;
  const int w = min(RT, R - c0);
  X += c0 * sx1;
  Y += c0 * sy1;
  const int rows_per_block = NT / lanes;
  const int g = tid / lanes;
  const int l = tid % lanes;
  const int grid = static_cast<int>(gridDim.x);
  const int bx = static_cast<int>(blockIdx.x);
  const int chunk = (row_blocks + grid - 1) / grid;
  const int rb_end = min(row_blocks, (bx + 1) * chunk);
  for (int rb = bx * chunk; rb < rb_end; ++rb) {
    const int r = rb * rows_per_block + g;
    float acc[RT];
#pragma unroll
    for (int t = 0; t < RT; ++t) acc[t] = 0.0f;
    if (r < rows) {
      const int end = vec_off[r + 1];
      for (int k = vec_off[r] + l; k < end; k += lanes) {
        RawVals<T> a;
        RawCols<I> c;
        a.load(vals + static_cast<int64_t>(k) * RawVals<T>::kPer);
        c.load(cols + static_cast<int64_t>(k) * V);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float xv[RT];
          gather_tile<K4, GATHER>(X, sx0, sx1, in_scale, c.get(j), w, xv);
          const float aj = a.get(j);
#pragma unroll
          for (int t = 0; t < RT; ++t) acc[t] = fmaf(aj, xv[t], acc[t]);
        }
      }
    }
    write_row(acc, part, lanes, r < rows, r < rows ? row_map[r] : 0,
              out_scale, Y, sy0, sy1, w);
  }
}

struct MatArgs {
  const void* vals;
  const void* cols;
  const int* vec_off;
  const int* row_map;
  const float* X;
  int64_t sx0, sx1;
  const float* in_scale;
  const float* out_scale;
  float* Y;
  int64_t sy0, sy1;
  int rows, R, lanes;
  cudaStream_t stream;
};

template <typename T, typename I, bool K4, int GATHER, int NT>
cudaError_t launch_mm(const MatArgs& a) {
  if (a.lanes < 1 || a.lanes > MAX_LANES || (a.lanes & (a.lanes - 1)) ||
      a.lanes > NT) {
    return cudaErrorInvalidValue;
  }
  if (GATHER == PACKED && (K4 || a.sx1 != 1 || a.sx0 % 4 ||
                           reinterpret_cast<uintptr_t>(a.X) % 16)) {
    return cudaErrorInvalidValue;
  }
  if (K4 != (a.in_scale != nullptr)) return cudaErrorInvalidValue;
  const int tiles = (a.R + RT - 1) / RT;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const int rows_per_block = NT / a.lanes;
  const int row_blocks = (a.rows + rows_per_block - 1) / rows_per_block;
  auto kernel = row_spmm_kernel<T, I, K4, GATHER, NT>;
  // resident blocks, queried once per instantiation
  static int cached_blocks = 0;
  if (cached_blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        NT, 0);
    if (err != cudaSuccess) return err;
    cached_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  const dim3 grid(row_blocks < cached_blocks ? row_blocks : cached_blocks,
                  tiles);
  kernel<<<grid, NT, 0, a.stream>>>(
      static_cast<const T*>(a.vals), static_cast<const I*>(a.cols), a.vec_off,
      a.row_map, a.X, a.sx0, a.sx1, a.in_scale, a.out_scale, a.Y, a.sy0,
      a.sy1, a.rows, a.R, a.lanes, row_blocks);
  return cudaGetLastError();
}

// K2 and K4 share the packed instantiation: K4's input is the scaled copy.
template <typename T, typename I, bool K4>
cudaError_t launch_gather(int gather, int threads, const MatArgs& a) {
  const bool big = threads == 1024;
  if (!big && threads != 256) return cudaErrorInvalidValue;
  switch (gather) {
    case STRIDED:
      return big ? launch_mm<T, I, K4, STRIDED, 1024>(a)
                 : launch_mm<T, I, K4, STRIDED, 256>(a);
    case PACKED:
      return big ? launch_mm<T, I, false, PACKED, 1024>(a)
                 : launch_mm<T, I, false, PACKED, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_mm_index(int wide, int k4, int gather, int threads,
                            const MatArgs& a) {
  if (wide) {
    return k4 ? launch_gather<T, int, true>(gather, threads, a)
              : launch_gather<T, int, false>(gather, threads, a);
  }
  return k4 ? launch_gather<T, uint16_t, true>(gather, threads, a)
            : launch_gather<T, uint16_t, false>(gather, threads, a);
}

// ---------------------------------------------------------------------------
// K2 and K4 with each thread block's window of X staged in shared memory
// (row_spmm_window): the same products, sums and bits as row_spmm_kernel,
// another way of reading X.  row_spmm_kernel gathers, for every stored entry,
// the RT values of its column of the tile from L1/L2 (one 32-byte sector, or
// eight 4-byte loads): at CT n=128 about 810 MB through L2 for A's 78 MB
// form.  Neighbouring rows read neighbouring columns (rays and pixels in
// Morton order), so the rows one block holds, taken in that order, read each
// of their distinct columns many times (15 on A's rows at n=128, 4-6 on the
// pixel rows at n=64, under 4 on those at n=128).
//
// Format: the window form (ops/sparse.py:RowWindows) beside the row form.
// The packed rows are placed in the order of the rows they hold (win_rows:
// the packed row at each place; the packed order sorts rows by length,
// which scatters neighbours).  Window w holds the rows at places win_row[w]
// .. win_row[w + 1] - 1, at most WNT / lanes of them, and reads the columns
// wcols[win_off[w] .. win_off[w + 1] - 1] (at most WIN_COLS); each stored
// slot holds, in place of its column, its 16-bit position in its window's
// list (local).  Values, vec_off, row_map and lanes are the row form's own.
//
// What bounds it: the bytes are the form (values + 16-bit local indices,
// the lists) from HBM once a tile and the staged columns of X from L2
// (about 54 MB on A at n=128, a fifteenth of the gathers), but the time
// follows the shared-memory reads (two 16-byte loads an entry, whose banks
// the random columns of a quarter-warp share), the copies and the barrier
// of each window: 116 against a byte bound of 27 us on A at n=128
// (chip_smoke.py's window_kernels, PERF.md).  A window is a small piece of
// work (each lane about two vectors), so the design keeps every load of a
// window off the path of the one before:
//   * persistent blocks of WNT = 1024 threads, one a multiprocessor, walking
//     windows blockIdx.x, + gridDim.x, ...; two buffers of staged columns,
//     the next window's copied while this one's are read;
//   * a window's columns copied with cp.async, column i of the list by
//     thread i mod WNT: X[c, 0:4] into lo[i], X[c, 4:8] into hi[i]; from a
//     row-major X on 16-byte rows in two 16-byte pieces (PACKED), else in
//     eight 4-byte pieces through X's strides (consecutive threads on
//     consecutive columns of a plane); nothing past the tile's width (its
//     sums are never written).  The list of the window after next is
//     loaded into registers while this one is worked on, so the copies are
//     issued without waiting on it;
//   * K4: each thread multiplies the columns it copied by in_scale (loaded
//     with the copies) once they have landed, x * s, the float32 product K3
//     forms, before the barrier that hands the window to the lanes: no copy
//     of U, no scale read in the loop;
//   * each lane streams its vectors across windows: the next window's row,
//     bounds and original row are loaded when a window starts, its first
//     vector while this window's last one is multiplied;
//   * lanes run row_spmm_kernel's loop on the local indices, two float4
//     loads from shared memory an entry (one for a tile of at most 4
//     columns).
// Bits: each lane adds its vectors in ascending order, slots in order, one
// fmaf per entry and column, then write_row: column j is K1's (K3's) on
// column j bit for bit, in both staging modes and at every R.
constexpr int WNT = 1024;
constexpr int WIN_COLS = 3584;                  // ops/sparse.py
constexpr int WK = (WIN_COLS + WNT - 1) / WNT;  // list entries a thread

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16 bytes (through L2 only) or of 4.  The barrier after
// copy_wait orders the copies against the lanes' reads.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A window's list, the part this thread copies: columns threadIdx.x + k WNT
// of the list (k < WK), n columns in all.
struct ListPart {
  int col[WK];
  int n;
};

__device__ __forceinline__ ListPart list_part(const int* __restrict__ wcols,
                                              const int* __restrict__ win_off,
                                              int win) {
  ListPart out;
  const int off = win_off[win];
  out.n = win_off[win + 1] - off;
#pragma unroll
  for (int k = 0; k < WK; ++k) {
    const int i = threadIdx.x + k * WNT;
    out.col[k] = i < out.n ? __ldg(wcols + off + i) : 0;
  }
  return out;
}

// Copy this thread's columns of the tile (width w) into (lo, hi).
template <bool PACKED>
__device__ __forceinline__ void stage(const float* __restrict__ X, int64_t sx0,
                                      int64_t sx1, const ListPart& part,
                                      int w, float4* lo, float4* hi) {
#pragma unroll
  for (int k = 0; k < WK; ++k) {
    const int i = threadIdx.x + k * WNT;
    if (i < part.n) {
      const float* src = X + part.col[k] * sx0;
      if (PACKED) {
        copy16(lo + i, src);
        if (w > 4) copy16(hi + i, src + 4);
      } else {
#pragma unroll
        for (int t = 0; t < RT; ++t) {
          if (t < w) {
            copy4(reinterpret_cast<float*>(t < 4 ? lo + i : hi + i) + (t & 3),
                  src + t * sx1);
          }
        }
      }
    }
  }
}

// in_scale of this thread's columns (K4).
__device__ __forceinline__ void load_scales(const float* __restrict__ in_scale,
                                            const ListPart& part,
                                            float s[WK]) {
#pragma unroll
  for (int k = 0; k < WK; ++k) {
    s[k] = threadIdx.x + k * WNT < part.n ? __ldg(in_scale + part.col[k])
                                          : 0.0f;
  }
}

// This thread's staged columns times their in_scale, once they landed.
__device__ __forceinline__ void scale_staged(const float s[WK], int n,
                                             float4* lo, float4* hi) {
#pragma unroll
  for (int k = 0; k < WK; ++k) {
    const int i = threadIdx.x + k * WNT;
    if (i < n) {
      float4& a = lo[i];
      float4& b = hi[i];
      a.x = a.x * s[k]; a.y = a.y * s[k]; a.z = a.z * s[k]; a.w = a.w * s[k];
      b.x = b.x * s[k]; b.y = b.y * s[k]; b.z = b.z * s[k]; b.w = b.w * s[k];
    }
  }
}

// A lane's place in the window it works on next: its row's vectors k ..
// end - 1 (stride lanes) when `valid`, and the row's original row.
struct LaneRow {
  int k, end, orow;
  bool valid;
};

__device__ __forceinline__ LaneRow lane_row(const int* __restrict__ win_row,
                                            const int* __restrict__ win_rows,
                                            const int* __restrict__ vec_off,
                                            const int* __restrict__ row_map,
                                            int win, int g, int l) {
  LaneRow out{0, 0, 0, false};
  const int p = win_row[win] + g;
  if (p < win_row[win + 1]) {
    const int r = win_rows[p];
    out = LaneRow{vec_off[r] + l, vec_off[r + 1], row_map[r], true};
  }
  return out;
}

// The staged columns: two buffers of [lo, hi][max_cols] float4.
template <typename T, bool K4, bool PACKED>
__global__ void __launch_bounds__(WNT, 1)
    row_spmm_window_kernel(const T* __restrict__ vals,
                           const uint16_t* __restrict__ local,
                           const int* __restrict__ vec_off,
                           const int* __restrict__ row_map,
                           const int* __restrict__ wcols,
                           const int* __restrict__ win_off,
                           const int* __restrict__ win_row,
                           const int* __restrict__ win_rows, int windows,
                           int max_cols, const float* __restrict__ X,
                           int64_t sx0, int64_t sx1,
                           const float* __restrict__ in_scale,
                           const float* __restrict__ out_scale,
                           float* __restrict__ Y, int64_t sy0, int64_t sy1,
                           int R, int lanes) {
  extern __shared__ float4 staged[];
  __shared__ float part[WNT / 32][RT];
  const int c0 = static_cast<int>(blockIdx.y) * RT;
  const int w = min(RT, R - c0);
  X += c0 * sx1;
  Y += c0 * sy1;
  const int g = threadIdx.x / lanes;
  const int l = threadIdx.x % lanes;
  const int step = static_cast<int>(gridDim.x);
  int win = static_cast<int>(blockIdx.x);
  if (win >= windows) return;
  // the first window staged; the list of the second loaded
  ListPart list = list_part(wcols, win_off, win);
  float scale[WK], next_scale[WK];
  if (K4) load_scales(in_scale, list, scale);
  stage<PACKED>(X, sx0, sx1, list, w, staged, staged + max_cols);
  copy_commit();
  int n = list.n;
  if (win + step < windows) list = list_part(wcols, win_off, win + step);
  LaneRow cur = lane_row(win_row, win_rows, vec_off, row_map, win, g, l);
  RawVals<T> a;
  RawCols<uint16_t> c;
  if (cur.valid && cur.k < cur.end) {
    a.load(vals + static_cast<int64_t>(cur.k) * RawVals<T>::kPer);
    c.load(local + static_cast<int64_t>(cur.k) * V);
  }
  for (int buf = 0; win < windows; win += step, buf ^= 1) {
    float4* lo = staged + 2 * buf * max_cols;
    float4* hi = lo + max_cols;
    copy_wait();   // this thread's columns of the window
    if (K4) scale_staged(scale, n, lo, hi);
    // every column landed (and scaled); every lane done with the other
    // buffer
    __syncthreads();
    const int next = win + step;
    if (next < windows) {
      float4* nlo = staged + 2 * (buf ^ 1) * max_cols;
      if (K4) load_scales(in_scale, list, next_scale);
      stage<PACKED>(X, sx0, sx1, list, w, nlo, nlo + max_cols);
      n = list.n;
      if (next + step < windows) {
        list = list_part(wcols, win_off, next + step);
      }
    }
    copy_commit();
    const LaneRow nxt = next < windows
                            ? lane_row(win_row, win_rows, vec_off, row_map,
                                       next, g, l)
                            : LaneRow{0, 0, 0, false};
    float acc[RT];
#pragma unroll
    for (int t = 0; t < RT; ++t) acc[t] = 0.0f;
    if (cur.valid && cur.k < cur.end) {
      int k = cur.k;
      while (true) {
        // the next vector of the stream: this row's, or the next window's
        // first; loaded before this one's products
        const int kn = k + lanes < cur.end ? k + lanes
                       : nxt.valid && nxt.k < nxt.end ? nxt.k : -1;
        RawVals<T> an;
        RawCols<uint16_t> cn;
        if (kn >= 0) {
          an.load(vals + static_cast<int64_t>(kn) * RawVals<T>::kPer);
          cn.load(local + static_cast<int64_t>(kn) * V);
        }
        if (w > 4) {
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const int i = c.get(j);
            const float4 xl = lo[i];
            const float4 xh = hi[i];
            const float aj = a.get(j);
            acc[0] = fmaf(aj, xl.x, acc[0]);
            acc[1] = fmaf(aj, xl.y, acc[1]);
            acc[2] = fmaf(aj, xl.z, acc[2]);
            acc[3] = fmaf(aj, xl.w, acc[3]);
            acc[4] = fmaf(aj, xh.x, acc[4]);
            acc[5] = fmaf(aj, xh.y, acc[5]);
            acc[6] = fmaf(aj, xh.z, acc[6]);
            acc[7] = fmaf(aj, xh.w, acc[7]);
          }
        } else {   // a tile of at most 4 columns: hi is not read
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float4 xl = lo[c.get(j)];
            const float aj = a.get(j);
            acc[0] = fmaf(aj, xl.x, acc[0]);
            acc[1] = fmaf(aj, xl.y, acc[1]);
            acc[2] = fmaf(aj, xl.z, acc[2]);
            acc[3] = fmaf(aj, xl.w, acc[3]);
          }
        }
        a = an;
        c = cn;
        if (k + lanes >= cur.end) break;
        k += lanes;
      }
    } else if (nxt.valid && nxt.k < nxt.end) {
      a.load(vals + static_cast<int64_t>(nxt.k) * RawVals<T>::kPer);
      c.load(local + static_cast<int64_t>(nxt.k) * V);
    }
    write_row(acc, part, lanes, cur.valid, cur.orow, out_scale, Y, sy0, sy1,
              w);
    cur = nxt;
    if (K4) {
#pragma unroll
      for (int k = 0; k < WK; ++k) scale[k] = next_scale[k];
    }
  }
}

struct WinArgs {
  const void* vals;
  const uint16_t* local;
  const int* vec_off;
  const int* row_map;
  const int* wcols;
  const int* win_off;
  const int* win_row;
  const int* win_rows;
  int windows, max_cols;
  const float* X;
  int64_t sx0, sx1;
  const float* in_scale;
  const float* out_scale;
  float* Y;
  int64_t sy0, sy1;
  int R, lanes;
  cudaStream_t stream;
};

template <typename T, bool K4, bool PACKED>
cudaError_t launch_window(const WinArgs& a) {
  if (a.lanes < 1 || a.lanes > MAX_LANES || (a.lanes & (a.lanes - 1))) {
    return cudaErrorInvalidValue;
  }
  if (PACKED && (a.sx1 != 1 || a.sx0 % 4 ||
                 reinterpret_cast<uintptr_t>(a.X) % 16)) {
    return cudaErrorInvalidValue;
  }
  if (K4 != (a.in_scale != nullptr)) return cudaErrorInvalidValue;
  const int tiles = (a.R + RT - 1) / RT;
  if (tiles > 65535 || a.max_cols < 0 || a.max_cols > WIN_COLS ||
      a.windows < 1) {
    return cudaErrorInvalidValue;
  }
  auto kernel = row_spmm_window_kernel<T, K4, PACKED>;
  const size_t smem = static_cast<size_t>(4) * WIN_COLS * sizeof(float4);
  // the multiprocessors, and the shared memory of the longest list allowed,
  // set once per instantiation
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, count = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    sms = count;
  }
  // one block a multiprocessor, the tiles side by side
  const int per_tile = sms / tiles > 0 ? sms / tiles : 1;
  const dim3 grid(a.windows < per_tile ? a.windows : per_tile, tiles);
  kernel<<<grid, WNT, static_cast<size_t>(4) * a.max_cols * sizeof(float4),
           a.stream>>>(static_cast<const T*>(a.vals), a.local, a.vec_off,
                       a.row_map, a.wcols, a.win_off, a.win_row, a.win_rows,
                       a.windows, a.max_cols, a.X, a.sx0, a.sx1, a.in_scale,
                       a.out_scale, a.Y, a.sy0, a.sy1, a.R, a.lanes);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_window_modes(int k4, int packed, const WinArgs& a) {
  if (k4) {
    return packed ? launch_window<T, true, true>(a)
                  : launch_window<T, true, false>(a);
  }
  return packed ? launch_window<T, false, true>(a)
                : launch_window<T, false, false>(a);
}

}  // namespace

// C entry point of K2/K4, loaded with ctypes.  dtype and wide as row_spmv;
// k4: 1 for the transposed product with its in_scale (gathered beside X,
// or, for the packed gather, multiplied into X by the caller: in_scale then
// null); gather: 0 strided, 1 packed (row-major X, rows on 16-byte
// boundaries and readable up to R rounded up to a multiple of 4); threads:
// 256 or 1024 per block.  X (ncols, R) and Y (rows, R) by element strides;
// in_scale (ncols,) and out_scale (rows,) may be null.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int row_spmm(int dtype, int wide, int k4, int gather, int threads,
                        const void* vals, const void* cols,
                        const void* vec_off, const void* row_map,
                        const void* X, int64_t sx0, int64_t sx1,
                        const void* in_scale, const void* out_scale, void* Y,
                        int64_t sy0, int64_t sy1, int rows, int ncols, int R,
                        int lanes, void* stream) {
  if (rows <= 0 || ncols <= 0 || R <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MatArgs a{vals,
                  cols,
                  static_cast<const int*>(vec_off),
                  static_cast<const int*>(row_map),
                  static_cast<const float*>(X),
                  sx0,
                  sx1,
                  static_cast<const float*>(in_scale),
                  static_cast<const float*>(out_scale),
                  static_cast<float*>(Y),
                  sy0,
                  sy1,
                  rows,
                  R,
                  lanes,
                  static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_mm_index<float>(wide, k4, gather, threads, a);
      break;
    case 1:
      err = launch_mm_index<__nv_bfloat16>(wide, k4, gather, threads, a);
      break;
    case 2:
      err = launch_mm_index<int8_t>(wide, k4, gather, threads, a);
      break;
    case 3:
      err = launch_mm_index<Nib4>(wide, k4, gather, threads, a);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// C entry point of K2/K4 on the window form, loaded with ctypes.  dtype as
// row_spmv; k4: 1 for the transposed product with its in_scale (multiplied
// into the staged columns); packed: 1 to stage a row-major X on 16-byte rows
// (readable up to R rounded up to a multiple of 4) in 16-byte pieces, 0
// through its strides.  local (16-bit), wcols, win_off (windows + 1),
// win_row (windows + 1) and win_rows (rows) are the window form of the row
// form (vals, vec_off, row_map, lanes) for blocks of 1024 threads; max_cols
// its longest list, at most 3584.  X (ncols, R)
// and Y (rows, R) by element strides; out_scale (rows,) may be null.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int row_spmm_window(int dtype, int k4, int packed,
                               const void* vals, const void* local,
                               const void* vec_off, const void* row_map,
                               const void* wcols, const void* win_off,
                               const void* win_row, const void* win_rows,
                               int windows, int max_cols,
                               const void* X, int64_t sx0, int64_t sx1,
                               const void* in_scale, const void* out_scale,
                               void* Y, int64_t sy0, int64_t sy1, int rows,
                               int R, int lanes, void* stream) {
  if (rows <= 0 || R <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const WinArgs a{vals,
                  static_cast<const uint16_t*>(local),
                  static_cast<const int*>(vec_off),
                  static_cast<const int*>(row_map),
                  static_cast<const int*>(wcols),
                  static_cast<const int*>(win_off),
                  static_cast<const int*>(win_row),
                  static_cast<const int*>(win_rows),
                  windows,
                  max_cols,
                  static_cast<const float*>(X),
                  sx0,
                  sx1,
                  static_cast<const float*>(in_scale),
                  static_cast<const float*>(out_scale),
                  static_cast<float*>(Y),
                  sy0,
                  sy1,
                  R,
                  lanes,
                  static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_window_modes<float>(k4, packed, a);
      break;
    case 1:
      err = launch_window_modes<__nv_bfloat16>(k4, packed, a);
      break;
    case 2:
      err = launch_window_modes<int8_t>(k4, packed, a);
      break;
    case 3:
      err = launch_window_modes<Nib4>(k4, packed, a);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
