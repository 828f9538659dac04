// K2 for wide right-hand-side blocks (K2w): Y = diag(s) Q X for X (ncols, R)
// float32, R from 16 columns on, on the tensor cores of NVIDIA Hopper.
//
// Replaces the Pallas TPU kernel hybrid_gmres_tpu/ops/spmv_pallas.py:
// _bucket_matmat (K2, wrapper bucketed_bsr_matmat, with the int8 row scale
// applied after it) on the port's multi-RHS forward products with R >=
// R_WIDE columns (ops/spmv_cuda.py): AB-RTP's A Q at R = maxit every step
// (solvers/rtp.py), GCV's A Q_k (reg/gcv.py) and the discrepancy
// principle's A X and B X (reg/discrepancy.py).  row_spmm_kernel
// (row_spmv.cu) keeps every product of fewer columns.
//
// Why a second design: row_spmm_kernel reads the row-packed form once per
// tile of 8 right-hand sides and gathers 8 floats of X per stored entry
// through L1/L2, with no reuse across rows.  At CT n=128 A and R=100 that is
// 13 reads of a 78 MB form and about 10.6 GB of gathers a call: 1.49 ms,
// slower than the library's CSR product.  Both sit on the cache traffic of
// an unordered gather, and neither uses the tensor cores.
//
// Format (ops/sparse.py:TilePacked): the matrix as its nonempty dense 16 x 16
// tiles.  Rows are cut into panels of 64 (four row groups of 16) in the
// operator's own row order (Morton rays at CT), columns into chunks of 16.
// A panel lists its nonempty chunks; each entry carries the mask of the row
// groups that hold a nonzero in it.  A row group's tiles follow each other in
// chunk order, stored as mma.m16n8k16 s8 A fragments so that each lane of
// a warp fetches its fragments of 2 (int8) or 4 (int4) tiles with one
// 16-byte load.  bf16 and float32 values are not integers: those forms keep
// row_spmm_kernel (a bf16 variant of this kernel, the planes as bf16 B
// fragments on the bf16 tensor cores, was slower than it on most CT shapes
// in a design run, and was taken out).
// At CT n=128 A the 26.4M nonzeros fill 403,268 tiles (25%) in 147,278
// panel entries.
//
// Arithmetic: X is split once per call by this file's first three kernels,
// per column: x ~ 2^(E-30) M with 2^E <= the column's largest |x| < 2^(E+1)
// and M the integer nearest x 2^(30-E) (|M| < 2^31: exact for every x
// within 2^7 of the column's largest, within 2^-31 of it otherwise), cut
// into its two's complement bytes M = 2^24 b0 + 2^16 b1 + 2^8 b2 + b3 (b0
// signed, the others unsigned), four planes.  The tensor cores multiply
// those bytes by the int8 or int4 values as integers (mma.sync m16n8k16
// s8.s8 / s8.u8, int32 accumulators): every product and every sum is exact
// (a row of fewer than 2^31 / (127 x 255) entries), the four plane sums are
// combined exactly in 64 bits, and the result, times the column's and the
// row's scale, is rounded once (with segments, each segment's sum, then
// their sum).  A column of X that is not finite gives NaN in every row the
// product touches.
//
// The error this gives is bounded row by row, not entry by entry: X is
// rounded to the grid 2^(E-30) of its column (fixed point), so row i of
// column r is within |s_i| sum_j |q_ij| 2^(E_r-31) of the exact product,
// plus the roundings of the result to float32 (one, or with segments one a
// segment and one an addition).  An entry 2^-20 below its column's largest
// keeps about 11 bits, and a row that reads only such entries gets a
// relative error far above K2r's (float32 per entry).  The
// solvers' blocks (Krylov bases, candidate solutions) are of one scale
// within a column, where this is below K2r's error (chip_smoke.py holds
// both: Gaussian columns against K2r's error, columns spread over 2^30
// against the row bound).
//
// The designs measured before this one, on the card: X split exactly into
// bf16 hi + mid + lo and each tile's float32 products added to the row's
// float32 sum (the error against a float64 product 1.5-4.8 times K2r's:
// one rounding per tile, up to 342 tiles a row at CT n=128 B, against K2r's
// lanes summed as a tree); three byte planes, M of 23 bits (2.3-2.7 times
// K2r's at CT B: X rounded to 23 bits of its column); panels of 128 rows
// (slower: 813 against 696 us at n=128 A, R=100).
//
// What bounds it on this card: the work is 2 x 4 x 16 x 16 x R integer
// operations per tile (84 G at n=128 A, R=100: 0.04 ms at the 1979 TOPS of
// the int8 tensor cores), the form 105 MB and X from HBM (0.03 ms), and the
// staged chunks of X from L2: a chunk's 16 x R bytes of each plane once per
// panel entry (0.94 GB at n=128 A, R=100).  Measured, the time follows the
// passes over the panel entries, not the bytes: at n=128 A about 112 us a
// pass of the grid plus 19 us a block of 8 columns (the latency of the
// entry loop: a barrier, a staged chunk and a chain of mma an entry), so
// the blocks of columns are as wide as the registers allow.  The design:
//   * one thread block of 4 warps per (panel, block of at most 40 columns,
//     segment of the panel's entries); warp w owns row group w and all its
//     accumulators (no atomics: every output element is summed by one
//     thread in a fixed order; the segments' partial sums are then added in
//     order by a finishing kernel);
//   * each chunk of X is staged once per panel entry in shared memory by
//     cp.async, in a ring of 8 stages, and read by every warp that has a
//     tile in it with ldmatrix (a plane's row of 16 bytes is one B
//     fragment's row: conflict-free); each warp stages its 16-byte groups
//     of tile fragments in a ring of its own, a group with its first tile;
//     two entries a barrier (5% faster than one; two warps a row group,
//     each half the columns, were slower: 703 against 573 us);
//   * no arithmetic per tile beside four mma of each block of 8 columns;
//   * segments of the entries on panels with many (CT B: a panel of 64
//     pixels meets 279 chunks of rays at n=64), so that enough thread
//     blocks run and none walks a long chain of entries;
//   * a thread block whose columns of X are all zero walks no entry: AB-RTP
//     hands the whole masked basis every step, its columns past the step
//     zero (at R=100, one or two of the three blocks of columns for two
//     thirds of the steps).  Skipping the zero columns inside a block too
//     cost 5-10% on full blocks in a design run, for no gain over a solve.
// Y is written through the caller's strides (row-major, or the transposed
// view of a column-major basis).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int TILE = 16;
constexpr int WARPS = 4;                // row groups of a panel, a warp each
constexpr int THREADS = 32 * WARPS;
constexpr int PANEL = TILE * WARPS;     // rows of a panel
constexpr int PLANES = 4;               // the bytes of M, highest first
constexpr int SPLIT_COLS = 64;          // columns of X per block of the split
constexpr int GROUP_ROWS = 256;         // rows of X per block of pass 1

// the ring of staged chunks
constexpr int STAGES = 8;
// most blocks of 8 columns a thread block holds (its int32 accumulators:
// 16 a block)
constexpr int MAX_NT = 5;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t r[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x1(uint32_t& r, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
               : "=r"(r)
               : "r"(addr)
               : "memory");
}

// d += A B, m16n8k16: A 16 x 16 (a fragment of 2 registers of s8), B 16 x 8
// (one register of s8 or u8), int32 accumulators (exact).
template <bool SIGNED_B>
__device__ __forceinline__ void mma_int(int d[4], const uint32_t a[2],
                                        uint32_t b) {
  if (SIGNED_B) {
    asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b));
  }
}

struct Nib4 {
  uint8_t b;
};

// A lane's 16 bytes of a group of G tiles -> the s8 A fragment of tile
// `sub` (slots 0-3: row g, k 4c..4c+3; slots 4-7: row g+8).
template <typename T>
struct Frag;

template <>
struct Frag<int8_t> {
  static constexpr int G = 2;
  __device__ __forceinline__ static void get(const uint4& w, int sub,
                                             uint32_t a[2]) {
    a[0] = sub ? w.z : w.x;
    a[1] = sub ? w.w : w.y;
  }
};

template <>
struct Frag<Nib4> {
  static constexpr int G = 4;
  // 8 nibbles (slot j in bits 4j..4j+3) -> 8 sign-extended bytes
  __device__ __forceinline__ static void get(const uint4& w, int sub,
                                             uint32_t a[2]) {
    const unsigned u = sub == 0 ? w.x : sub == 1 ? w.y : sub == 2 ? w.z : w.w;
    const unsigned even = u & 0x0F0F0F0Fu, odd = (u >> 4) & 0x0F0F0F0Fu;
    a[0] = __vsub4(__byte_perm(even, odd, 0x5140) ^ 0x08080808u,
                   0x08080808u);
    a[1] = __vsub4(__byte_perm(even, odd, 0x7362) ^ 0x08080808u,
                   0x08080808u);
  }
};

// The blocks of columns: R's nq = ceil(R / 8) blocks of 8 columns shared out
// among nb blocks as evenly as they go, block b taking blocks of 8
// [b nq / nb, (b + 1) nq / nb).
__host__ __device__ __forceinline__ int block_start(int b, int nq, int nb) {
  return static_cast<int>(static_cast<int64_t>(b) * nq / nb);
}

// Bytes of a staged chunk of cbw columns: four planes of (cbw, 16) bytes,
// row n of a plane the 16 digits of column n (one B fragment's row).
__host__ __device__ __forceinline__ int64_t chunk_bytes(int cbw) {
  return static_cast<int64_t>(PLANES * TILE) * cbw;
}

// The split, pass 1: the largest |x| of each column of X (ncols, R) over a
// group of GROUP_ROWS rows of X (NaN where one is not finite), into
// part[group][column].  A row-major X is read by 32 neighbouring columns a
// warp, a column-major one by 32 neighbouring rows a warp; every thread's
// loads are independent (the maximum is taken after them).
__global__ void __launch_bounds__(256)
    colmax_kernel(const float* __restrict__ X, int64_t sx0, int64_t sx1,
                  float* __restrict__ part, int ncols, int R,
                  int row_major) {
  __shared__ float best_of[8][33];
  __shared__ int bad_of[8][33];
  const int lane = threadIdx.x & 31, wy = threadIdx.x >> 5;
  const int c0 = blockIdx.x * GROUP_ROWS;
  if (row_major) {             // warp wy: rows c0 + wy + 8 i, column r
    const int r = blockIdx.y * 32 + lane;
    float best = 0.0f;
    int bad = 0;
#pragma unroll 8
    for (int i = 0; i < GROUP_ROWS / 8; ++i) {
      const int c = c0 + wy + 8 * i;
      if (c < ncols && r < R) {
        const float v = X[c * sx0 + r * sx1];
        best = fmaxf(best, fabsf(v));
        bad |= !isfinite(v);
      }
    }
    best_of[wy][lane] = best;
    bad_of[wy][lane] = bad;
    __syncthreads();
    if (wy == 0 && r < R) {
      for (int k = 1; k < 8; ++k) {
        best = fmaxf(best, best_of[k][lane]);
        bad |= bad_of[k][lane];
      }
      part[static_cast<int64_t>(blockIdx.x) * R + r] =
          bad ? __int_as_float(0x7fc00000) : best;
    }
    return;
  }
  // column-major: warp wy takes columns blockIdx.y * 32 + wy + 8 k
  for (int k = 0; k < 4; ++k) {
    const int r = blockIdx.y * 32 + wy + 8 * k;
    float b = 0.0f;
    int bd = 0;
#pragma unroll 8
    for (int i = 0; i < GROUP_ROWS / 32; ++i) {
      const int c = c0 + lane + 32 * i;
      if (c < ncols && r < R) {
        const float v = X[c * sx0 + r * sx1];
        b = fmaxf(b, fabsf(v));
        bd |= !isfinite(v);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, o));
      bd |= __shfl_xor_sync(0xffffffffu, bd, o);
    }
    if (lane == 0 && r < R) {
      part[static_cast<int64_t>(blockIdx.x) * R + r] =
          bd ? __int_as_float(0x7fc00000) : b;
    }
  }
}

// The split, pass 2: for each column, E with 2^E <= max |x| < 2^(E+1) over
// the groups' maxima (INT_MIN for a zero column, INT_MAX for one that is
// not finite), and its scale 2^(E-30), the weight of M's unit (zero; NaN).
// A warp a column.
__global__ void __launch_bounds__(256)
    colscale_kernel(const float* __restrict__ part, int groups, int R,
                    int* __restrict__ col_e, float* __restrict__ col_scale) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= R) return;
  float best = 0.0f;
  int bad = 0;
#pragma unroll 4
  for (int g = lane; g < groups; g += 32) {
    const float v = part[static_cast<int64_t>(g) * R + r];
    best = fmaxf(best, v);
    bad |= v != v;
  }
  for (int o = 16; o > 0; o >>= 1) {
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, o));
    bad |= __shfl_xor_sync(0xffffffffu, bad, o);
  }
  if (lane == 0) {
    const int e = bad ? INT_MAX : (best == 0.0f ? INT_MIN : ilogbf(best));
    col_e[r] = e;
    col_scale[r] = e == INT_MAX   ? __int_as_float(0x7fc00000)
                   : e == INT_MIN ? 0.0f
                                  : scalbnf(1.0f, e - 30);
  }
}

// The split, pass 3: X (ncols, R) -> for each block of columns of X (the
// blocks of block_start), for each chunk of 16 rows of X, the chunk as the main
// kernel stages it: the bytes of M = rint(x 2^(30-E)) (|M| < 2^31: two's
// complement, the high byte signed, the others unsigned), four (cbw, 16)
// planes, cbw = 8 x its blocks of 8, zero past ncols and R: the blocks one
// after the other, chunk by chunk.
// One thread block per (chunk, SPLIT_COLS columns), through shared memory
// so that both layouts of X are read in whole sectors.
__global__ void __launch_bounds__(256)
    split_kernel(const float* __restrict__ X, int64_t sx0, int64_t sx1,
                 const int* __restrict__ col_e, uint8_t* __restrict__ xs,
                 int ncols, int R, int nb, int nchunks, int row_major) {
  __shared__ float t[SPLIT_COLS][TILE + 1];
  __shared__ int e_of[SPLIT_COLS];
  const int chunk = blockIdx.x;
  const int r0 = blockIdx.y * SPLIT_COLS;
#pragma unroll
  for (int i = threadIdx.x; i < TILE * SPLIT_COLS; i += 256) {
    const int k = row_major ? i / SPLIT_COLS : i % TILE;
    const int cc = row_major ? i % SPLIT_COLS : i / TILE;
    const int c = chunk * TILE + k, r = r0 + cc;
    t[cc][k] = (c < ncols && r < R) ? X[c * sx0 + r * sx1] : 0.0f;
  }
  if (threadIdx.x < SPLIT_COLS) {
    const int r = r0 + threadIdx.x;
    e_of[threadIdx.x] = r < R ? col_e[r] : INT_MIN;
  }
  __syncthreads();
#pragma unroll
  for (int i = threadIdx.x; i < TILE * SPLIT_COLS; i += 256) {
    const int k = i % TILE, cc = i / TILE;
    const int r = r0 + cc;
    const int nq = (R + 7) / 8, q = r / 8;
    if (q >= nq) continue;
    const int b = static_cast<int>((static_cast<int64_t>(q + 1) * nb - 1) / nq);
    const int q0 = block_start(b, nq, nb);
    const int cbw = 8 * (block_start(b + 1, nq, nb) - q0), rb = r - 8 * q0;
    uint8_t* dst = xs + nchunks * chunk_bytes(8 * q0) +
                   static_cast<int64_t>(chunk) * chunk_bytes(cbw) + rb * TILE +
                   k;
    const int e = e_of[cc];
    const float x = t[cc][k];
    int m = 0;
    if (e != INT_MIN && e != INT_MAX) {
      // below 2^31: 2^30 <= |x| 2^(30-E) < 2^31 in the top binade, an
      // integer multiple of 2^7 there (the largest float below 2^31)
      m = static_cast<int>(fminf(rintf(scalbnf(fabsf(x), 30 - e)),
                                 2147483520.0f));
      m = x < 0.0f ? -m : m;
    }
#pragma unroll
    for (int pl = 0; pl < PLANES; ++pl) {
      dst[pl * cbw * TILE] = static_cast<uint8_t>(m >> (8 * (PLANES - 1 - pl)));
    }
  }
}

// The main kernel.  NT: most blocks of 8 columns a thread block holds.
// Each warp chains its row group's products with the four planes into
// int32 accumulators (exact for any row of fewer than 2^31 / (127 x 255)
// entries), combined exactly in the epilogue.  part: null to write diag(s)
// (sum) 2^(E-30) into Y, else the segment's partial sums times 2^(E-30)
// into part[segment][row][column] for finish_kernel.
template <typename T, int NT>
__global__ void __launch_bounds__(THREADS, 4)
    tile_spmm_kernel(const uint4* __restrict__ vals,
                     const int* __restrict__ ent,
                     const int* __restrict__ panel_off,
                     const int* __restrict__ rg_off,
                     const uint4* __restrict__ xs,
                     const float* __restrict__ col_scale,
                     const float* __restrict__ scale, float* __restrict__ Y,
                     int64_t sy0, int64_t sy1, float* __restrict__ part,
                     int rows, int R, int nchunks) {
  extern __shared__ uint4 ring[];
  // the ring: STAGES slots of a chunk of X (16-byte units), then each
  // warp's ring of STAGES 16-byte groups a lane of its tile fragments (a
  // group is staged with its first tile, and serves its G tiles)
  constexpr int SLOT = NT * 8 * PLANES;
  constexpr int GROUPS = STAGES * SLOT;
  constexpr int G = Frag<T>::G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p = blockIdx.x;
  const int nq = (R + 7) / 8, nb = gridDim.y;   // blocks of 8 columns
  const int q0 = block_start(blockIdx.y, nq, nb);
  const int nt = block_start(blockIdx.y + 1, nq, nb) - q0;
  const int c0 = 8 * q0;
  const int w = min(8 * (q0 + nt), R) - c0;
  const int cbw = nt * 8;
  const int su = static_cast<int>(chunk_bytes(cbw) / 16);  // 16-byte units
  const unsigned plane_bytes = cbw * TILE;
  const uint4* xb = xs + nchunks * chunk_bytes(c0) / 16;
  // a block whose columns of X are all zero (scale 0: the masked basis of
  // AB-RTP past the step) walks no entry and writes zeros
  const float s_lo = lane < w ? col_scale[c0 + lane] : 0.0f;
  const float s_hi = lane + 32 < w ? col_scale[c0 + lane + 32] : 0.0f;
  // this segment's entries (loaded beside the scales)
  const int pe0 = panel_off[p], pe1 = panel_off[p + 1];
  const bool live = __any_sync(0xffffffffu, s_lo != 0.0f || s_hi != 0.0f);
  const int nseg = gridDim.z, seg = blockIdx.z;
  const int e0 = pe0 + static_cast<int>(
                           static_cast<int64_t>(pe1 - pe0) * seg / nseg);
  const int e1 = !live ? e0
                       : pe0 + static_cast<int>(static_cast<int64_t>(pe1 - pe0) *
                                                (seg + 1) / nseg);
  const unsigned ring_s = smem_addr(ring);

  // this warp's first tile: its row group's tiles in the entries before
  // the segment, counted a warp's width at a time
  const int rg = p * WARPS + warp;
  int before = 0;
#pragma unroll 8
  for (int i = pe0 + lane; i < e0; i += 32) before += (__ldg(ent + i) >> warp) & 1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(0xffffffffu, before, o);
  const int t_first = rg_off[rg] + before;
  int t = t_first;               // the next tile to multiply
  int t_in = t_first;            // the next tile to stage

  // the chunk ids of the entries staged ahead: ev[i] is entry e + i's
  int ev[STAGES];
#pragma unroll
  for (int i = 0; i < STAGES; ++i) ev[i] = e0 + i < e1 ? __ldg(ent + e0 + i) : 0;
  auto stage = [&](int chunk_ent, int slot) {
    const uint4* src = xb + static_cast<int64_t>(chunk_ent >> 4) * su;
    const unsigned dst = ring_s + slot * SLOT * 16;
    for (int i = tid; i < su; i += THREADS) cp_async16(dst + i * 16, src + i);
    if ((chunk_ent >> warp) & 1) {   // this warp's tile
      if (t_in % G == 0 || t_in == t_first) {   // its group's first here
        const int g = t_in / G;
        cp_async16(ring_s + (GROUPS + (warp * STAGES + g % STAGES) * 32 +
                             lane) * 16,
                   vals + static_cast<int64_t>(g) * 32 + lane);
      }
      ++t_in;
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (e0 + s < e1) stage(ev[s], s);
    cp_commit();
  }

  // d: the chained products with each plane
  int d[NT][PLANES][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int pl = 0; pl < PLANES; ++pl) d[j][pl][i] = 0;
    }
  }
  const int gq = lane >> 2, c4 = lane & 3;

  // one entry's products: this warp's tile of it, if it has one
  auto consume = [&](int e, int mine) {
    if (!((mine >> warp) & 1)) return;
    const int slot = (e - e0) % STAGES;
    uint32_t a[2];
    Frag<T>::get(ring[GROUPS + (warp * STAGES + (t / G) % STAGES) * 32 + lane],
                 t % G, a);
    ++t;
    const unsigned base = ring_s + slot * SLOT * 16;
    // x2: lanes 0-7 rows of block j, lanes 8-15 rows of block j + 1
    const unsigned row2 = ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j >= nt) break;
      if (j + 1 < nt) {
#pragma unroll
        for (int pl = 0; pl < PLANES; ++pl) {
          uint32_t b[2];
          ldsm_x2(b, base + pl * plane_bytes + (j * 8 + row2) * 16);
          if (pl == 0) {
            mma_int<true>(d[j][pl], a, b[0]);
            mma_int<true>(d[j + 1][pl], a, b[1]);
          } else {
            mma_int<false>(d[j][pl], a, b[0]);
            mma_int<false>(d[j + 1][pl], a, b[1]);
          }
        }
      } else {
#pragma unroll
        for (int pl = 0; pl < PLANES; ++pl) {
          uint32_t b;
          ldsm_x1(b, base + pl * plane_bytes + (j * 8 + (lane & 7)) * 16);
          if (pl == 0) {
            mma_int<true>(d[j][pl], a, b);
          } else {
            mma_int<false>(d[j][pl], a, b);
          }
        }
      }
    }
  };
  // two entries a barrier: the ring holds the STAGES - 2 entries after the
  // pair, staged into the slots of the pair before
  for (int e = e0; e < e1; e += 2) {
    cp_wait<STAGES - 4>();
    __syncthreads();
    const int mine0 = ev[0], mine1 = ev[1];
    const int next0 = ev[STAGES - 2], next1 = ev[STAGES - 1];
#pragma unroll
    for (int i = 0; i < STAGES - 2; ++i) ev[i] = ev[i + 2];
    ev[STAGES - 2] = e + STAGES < e1 ? __ldg(ent + e + STAGES) : 0;
    ev[STAGES - 1] = e + STAGES + 1 < e1 ? __ldg(ent + e + STAGES + 1) : 0;
    if (e + STAGES - 2 < e1) stage(next0, (e + STAGES - 2 - e0) % STAGES);
    cp_commit();
    if (e + STAGES - 1 < e1) stage(next1, (e + STAGES - 1 - e0) % STAGES);
    cp_commit();
    consume(e, mine0);
    if (e + 1 < e1) consume(e + 1, mine1);
  }
  cp_wait<0>();

  // element (j, i): row gq + 8 (i / 2), column 8 j + 2 c4 + i % 2
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = p * PANEL + warp * TILE + gq + 8 * h;
    if (part == nullptr && row >= rows) continue;
    const double s = (part == nullptr && scale != nullptr) ? scale[row] : 1.0;
    float* y = part != nullptr
                   ? part + (static_cast<int64_t>(blockIdx.z) * gridDim.x *
                                 PANEL + row) * R + c0
                   : Y + static_cast<int64_t>(row) * sy0 + c0 * sy1;
    const int64_t step = part != nullptr ? 1 : sy1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = j * 8 + 2 * c4 + q;
        if (col >= w) continue;
        const int i = 2 * h + q;
        // the plane sums' weights, exactly
        const double v = static_cast<double>(
            (static_cast<int64_t>(d[j][0][i]) << 24) +
            (static_cast<int64_t>(d[j][1][i]) << 16) +
            (static_cast<int64_t>(d[j][2][i]) << 8) + d[j][3][i]);
        y[col * step] = static_cast<float>(s * (v * col_scale[c0 + col]));
      }
    }
  }
}

// Y = diag(s) (the segments' partial sums, added in segment order).
__global__ void __launch_bounds__(256)
    finish_kernel(const float* __restrict__ part, int nseg, int64_t prows,
                  const float* __restrict__ scale, float* __restrict__ Y,
                  int64_t sy0, int64_t sy1, int rows, int R) {
  const int64_t n = static_cast<int64_t>(rows) * R;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = i / R, col = i - row * R;
    float sum = part[i];
    for (int s = 1; s < nseg; ++s) sum += part[s * prows * R + i];
    Y[row * sy0 + col * sy1] = scale != nullptr ? scale[row] * sum : sum;
  }
}

struct TileArgs {
  const void* vals;
  const int* ent;
  const int* panel_off;
  const int* rg_off;
  const uint4* xs;
  const float* col_scale;
  const float* scale;
  float* Y;
  int64_t sy0, sy1;
  float* part;
  int rows, R, nchunks, panels, nb, nseg;
  cudaStream_t stream;
};

template <typename T, int NT>
cudaError_t launch_tiles(const TileArgs& a) {
  constexpr int smem = STAGES * (NT * 8 * PLANES * TILE + WARPS * 512);
  static_assert(smem <= 48 * 1024, "the ring fits the default limit");
  tile_spmm_kernel<T, NT><<<dim3(a.panels, a.nb, a.nseg), THREADS, smem,
                            a.stream>>>(
      static_cast<const uint4*>(a.vals), a.ent, a.panel_off, a.rg_off, a.xs,
      a.col_scale, a.scale, a.Y, a.sy0, a.sy1, a.part, a.rows, a.R,
      a.nchunks);
  return cudaGetLastError();
}

template <typename T_>
cudaError_t launch_width(const TileArgs& a) {
  const int nq = (a.R + 7) / 8;
  return (nq + a.nb - 1) / a.nb <= 2 ? launch_tiles<T_, 2>(a)
                                      : launch_tiles<T_, MAX_NT>(a);
}

}  // namespace

// C entry point, loaded with ctypes.  dtype: 2 int8, 3 int4 (nibble
// pairs), the codes of row_spmv.  The tile form (vals 16-byte
// aligned, ent, panel_off, rg_off; `panels` panels of 64 rows), X (ncols, R)
// and Y (rows, R) by element strides, scale (rows,) or null.  nb: blocks of
// columns, at most MAX_NT blocks of 8 columns each; nseg: segments of each
// panel's entries.  xs: the caller's scratch for the split chunks, 16-byte
// aligned, of nchunks * 64 * 8 * ceil(R / 8) bytes; words: (ceil(ncols /
// 256) + 2) * R 4-byte words (the split's column maxima, exponents and
// scales); part: with nseg > 1, scratch for nseg * panels * 64 * R floats
// (else null).  Launches the split (three passes), the product and, with
// nseg > 1, the finishing sum; returns the cudaError_t of the launches (0
// on success).
extern "C" int tile_spmm(int dtype, const void* vals, const void* ent,
                         const void* panel_off, const void* rg_off,
                         const void* X, int64_t sx0, int64_t sx1, void* xs,
                         void* words, const void* scale, void* Y, int64_t sy0,
                         int64_t sy1, void* part, int rows, int ncols, int R,
                         int nb, int nseg, int panels, void* stream) {
  const int nq = (R + 7) / 8;
  if (rows <= 0 || ncols <= 0 || R <= 0 || nb < 1 || nb > 65535 || nb > nq ||
      (nq + nb - 1) / nb > MAX_NT || nseg < 1 || nseg > 65535 ||
      (nseg > 1) != (part != nullptr) ||
      panels != (rows + PANEL - 1) / PANEL ||
      reinterpret_cast<uintptr_t>(vals) % 16 ||
      reinterpret_cast<uintptr_t>(xs) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nchunks = (ncols + TILE - 1) / TILE;
  const int groups = (ncols + GROUP_ROWS - 1) / GROUP_ROWS;
  float* gmax = static_cast<float*>(words);
  int* col_e = reinterpret_cast<int*>(gmax + static_cast<int64_t>(groups) * R);
  float* col_scale = reinterpret_cast<float*>(col_e + R);
  const float* Xf = static_cast<const float*>(X);
  const int row_major = sx1 == 1 ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  colmax_kernel<<<dim3(groups, (R + 31) / 32), 256, 0, s>>>(
      Xf, sx0, sx1, gmax, ncols, R, row_major);
  colscale_kernel<<<(R + 7) / 8, 256, 0, s>>>(gmax, groups, R, col_e,
                                              col_scale);
  split_kernel<<<dim3(nchunks, (8 * nq + SPLIT_COLS - 1) / SPLIT_COLS), 256, 0,
                 s>>>(Xf, sx0, sx1, col_e, static_cast<uint8_t*>(xs), ncols,
                      R, nb, nchunks, row_major);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const TileArgs a{vals,
                   static_cast<const int*>(ent),
                   static_cast<const int*>(panel_off),
                   static_cast<const int*>(rg_off),
                   static_cast<const uint4*>(xs),
                   col_scale,
                   static_cast<const float*>(scale),
                   static_cast<float*>(Y),
                   sy0,
                   sy1,
                   static_cast<float*>(part),
                   rows,
                   R,
                   nchunks,
                   panels,
                   nb,
                   nseg,
                   s};
  switch (dtype) {
    case 2:
      err = launch_width<int8_t>(a);
      break;
    case 3:
      err = launch_width<Nib4>(a);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || nseg == 1) return static_cast<int>(err);
  const int64_t n = static_cast<int64_t>(rows) * R;
  const int blocks = static_cast<int>(n / 256 + 1 < 4096 ? n / 256 + 1 : 4096);
  finish_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(part), nseg,
      static_cast<int64_t>(panels) * PANEL, static_cast<const float*>(scale),
      static_cast<float*>(Y), sy0, sy1, rows, R);
  return static_cast<int>(cudaGetLastError());
}
