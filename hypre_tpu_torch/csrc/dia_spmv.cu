// DIA sparse matrix-vector product for Hopper (sm_90a):
//
//     y[i] = sum_d dvals[d, i] * x[i + offsets[d]],   x read as 0 outside [0, n_cols)
//
// Replaces two TPU kernels of the reference package:
//   - hypre_tpu/seq/dia.py::_dia_kernel (offsets in a device array, reached
//     through _dia_pallas_call / dia_spmv_pallas)       -> dia_dyn_kernel,
//                                     dia_rows_kernel<T, G, DeviceTable>
//   - hypre_tpu/seq/dia.py::_dia_kernel_static (offsets fixed at compile time,
//     _dia_pallas_call_static / dia_spmv_pallas_static) -> dia_static_kernel<T, D>,
//                                     dia_rows_kernel<T, G, ParamTable>
//
// What bounds it on this card: device-memory bandwidth. Each row reads D
// values of dvals and writes one y, with 2*D flops; x is read D times per row
// but at offsets within +-nx*ny rows of the row itself, so one block's D
// windows of x lie in L2 (50 MB holds all of x at 128^3) and x leaves DRAM
// about once. At 128^3, D=7, f32 the least traffic is (7+1+1)*n*4 B = 75.5 MB,
// 22.5 us at 3.35 TB/s; the 14.7 MFLOP are nothing against the FP32 rate.
//
// What the design does about it: one thread per row, so the 32 threads of a
// warp read 32 consecutive dvals of one diagonal (one 128-byte line per
// diagonal in f32) and write 32 consecutive y; x goes through the read-only
// cache with __ldg, and the zero fill at the ends is a bounds test rather
// than a padded copy of x. The dynamic kernel loads the D offsets into shared
// memory once per block; the static one takes them by value in a struct, so
// its loop over diagonals unrolls and the offsets sit in constant space. The
// TPU's 1024-aligned x windows, its block-major dvals copy (a DMA-descriptor
// trick) and its lane-rotate decomposition have no counterpart here.
//
// Arithmetic: products and sums are rounded separately (no fused multiply-
// add) and taken in diagonal order, as the plain PyTorch version in
// hypre_tpu_torch/seq/dia.py does, so the two agree bit for bit.
//
// The row-list route (dia_rows_kernel) computes the same y from a compact
// layout of the same planes, for planes that are mostly zero (the D = 64
// fine-space transfer planes of a TransferDia hold ~2 % nonzeros): per row,
// its nonzeros in ascending plane order as (plane id: uint8, value), behind
// a row pointer (seq/dia.py::compact_dia builds it once per operator). The
// dense kernels stream all D*n values; this one moves nnz*5 + (n+1)*4 bytes
// of layout, y, and x at the columns the layout reaches (at 128^3: 32.8 MB
// for P, whose x is nonzero at the C points only, 40.7 MB for P^T; against
// 537 MB of planes). It is bound by those bytes and by the latency of the
// dependent loads (row pointer -> plane id -> offset -> x). Two schedules,
// picked once per operator from the mean length of the non-empty rows:
//   - lanes == 1: a thread sums whole rows (P: 1-4 entries a row), so a
//     warp's row-pointer, id and value loads are nearly contiguous.
//   - lanes == 4: the non-empty rows are listed (P^T: ~6 % of the rows, ~25
//     entries each); a group of 4 lanes loads 4 entries of one
//     row at a time and its sum is taken IN ENTRY ORDER, one shuffled
//     product after the other, so the loads are parallel and the order of
//     the adds is that of one thread. The empty rows get their zero from a
//     thread-per-row pass in the same launch.
// Every y is written once, no atomics. Skipping a zero term changes no bit
// of the sum for finite x: the accumulator starts at +0 and never becomes
// -0, and acc + (+-0) == acc. So the row-list kernel agrees bit for bit
// with the dense kernels and their plain versions.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Static instantiations: every D up to try_dia's max_offsets, and above it
// the values that TransferDia pads its diagonal count to (the setup's width
// ladder up to probe_transfer_offsets' limit). kMaxStaticD also sizes the
// offset table the static row-list kernel takes in its parameters.
constexpr int kMaxDenseStaticD = 48;
constexpr int kMaxStaticD = 96;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_dyn_kernel(const T* __restrict__ dvals, const int* __restrict__ offsets,
               const T* __restrict__ x, T* __restrict__ y,
               long long n_rows, long long n_cols, int D) {
  extern __shared__ int s_off[];
  for (int d = threadIdx.x; d < D; d += blockDim.x) s_off[d] = offsets[d];
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  T acc = T(0);
  for (int d = 0; d < D; ++d) {
    const long long j = i + s_off[d];
    const T xv = (j >= 0 && j < n_cols) ? __ldg(x + j) : T(0);
    acc = add_rn(acc, mul_rn(__ldg(dvals + (long long)d * n_rows + i), xv));
  }
  y[i] = acc;
}

template <int D>
struct DiaOffsets {
  int o[D];
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dia_static_kernel(const T* __restrict__ dvals, const DiaOffsets<D> offs,
                  const T* __restrict__ x, T* __restrict__ y,
                  long long n_rows, long long n_cols) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  T acc = T(0);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const long long j = i + offs.o[d];
    const T xv = (j >= 0 && j < n_cols) ? __ldg(x + j) : T(0);
    acc = add_rn(acc, mul_rn(__ldg(dvals + (long long)d * n_rows + i), xv));
  }
  y[i] = acc;
}

template <typename T>
cudaError_t launch_dyn(const void* dvals, const void* offsets, const void* x,
                       void* y, long long n_rows, long long n_cols, int D,
                       void* stream) {
  if (n_rows > 0) {
    const unsigned blocks = (unsigned)((n_rows + kThreads - 1) / kThreads);
    dia_dyn_kernel<T><<<blocks, kThreads, D * sizeof(int),
                        (cudaStream_t)stream>>>(
        (const T*)dvals, (const int*)offsets, (const T*)x, (T*)y, n_rows,
        n_cols, D);
  }
  return cudaGetLastError();
}

// The next smaller diagonal count that has an instantiation: the ladder
// values above kMaxDenseStaticD, every count below.
constexpr int next_static_d(int d) {
  return d > 80 ? 80 : d > 64 ? 64 : d > 56 ? 56
       : d > kMaxDenseStaticD ? kMaxDenseStaticD : d - 1;
}

// Finds the instantiation for the run-time diagonal count by recursion
// from kMaxStaticD down to 1; a count without one is an invalid value.
template <typename T, int D>
cudaError_t launch_static(int want, const int* offs_host, const void* dvals,
                          const void* x, void* y, long long n_rows,
                          long long n_cols, void* stream) {
  if constexpr (D == 0) {
    return cudaErrorInvalidValue;
  } else {
    if (want != D)
      return launch_static<T, next_static_d(D)>(want, offs_host, dvals, x, y,
                                                n_rows, n_cols, stream);
    DiaOffsets<D> offs;
    for (int d = 0; d < D; ++d) offs.o[d] = offs_host[d];
    if (n_rows > 0) {
      const unsigned blocks = (unsigned)((n_rows + kThreads - 1) / kThreads);
      dia_static_kernel<T, D><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)dvals, offs, (const T*)x, (T*)y, n_rows, n_cols);
    }
    return cudaGetLastError();
  }
}

// ---------------------------------------------------------------------------
// Row-list route. The offset table goes to shared memory once per block that
// sums rows, from a device array (dynamic kernel) or from the kernel's
// parameters (static kernel): the plane id of an entry is data, so the table
// is read at a run-time index either way.
// ---------------------------------------------------------------------------

struct DeviceTable {
  const int* offsets;
  __device__ int get(int d) const { return __ldg(offsets + d); }
};

struct ParamTable {
  int o[kMaxStaticD];
  __device__ int get(int d) const { return o[d]; }
};

template <typename T>
__device__ __forceinline__ T row_term(const int* s_off,
                                      const unsigned char* __restrict__ r_ids,
                                      const T* __restrict__ r_vals,
                                      const T* __restrict__ x, long long i,
                                      int k, long long n_cols) {
  const long long j = i + s_off[__ldg(r_ids + k)];
  const T xv = (j >= 0 && j < n_cols) ? __ldg(x + j) : T(0);
  return mul_rn(__ldg(r_vals + k), xv);
}

// Loads in flight: the kernel waits on chains of dependent loads (row
// pointer -> plane id -> offset -> x), so each thread keeps several going.
// Thread-per-row pass: kRowsPerThread rows a thread, the first
// kRowsUnroll entries of each loaded before the first is added. Lane
// groups: kListUnroll rounds of `lanes` entries loaded before they are
// added. (Chosen by timing variants on the 128^3 transfer planes on an
// H100: 1 or 4 rows a thread were slower than 2.)
constexpr int kRowsPerThread = 2;
constexpr int kRowsUnroll = 4;
constexpr int kListUnroll = 2;

template <class Table>
__device__ __forceinline__ void load_table(const Table& table, int* s_off,
                                           int D) {
  for (int d = threadIdx.x; d < D; d += blockDim.x) s_off[d] = table.get(d);
  __syncthreads();
}

// Blocks [0, list_blocks) run the lane groups over the listed rows (lanes >
// 1 only); the blocks after them take kRowsPerThread rows a thread: the
// whole row when lanes == 1, the zero of an empty row otherwise (those
// blocks read no offset).
template <typename T, int G, class Table>
__global__ void __launch_bounds__(kThreads)
dia_rows_kernel(const __grid_constant__ Table table,
                const int* __restrict__ r_ptr,
                const unsigned char* __restrict__ r_ids,
                const T* __restrict__ r_vals, const int* __restrict__ r_rows,
                const T* __restrict__ x, T* __restrict__ y, long long n_rows,
                long long n_cols, int D, long long n_list, int list_blocks) {
  extern __shared__ int s_off[];
  const long long i0 =
      ((long long)blockIdx.x - list_blocks) * kThreads * kRowsPerThread +
      threadIdx.x;
  if constexpr (G > 1) {
    if ((int)blockIdx.x >= list_blocks) {
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const long long i = i0 + r * kThreads;
        if (i < n_rows && __ldg(r_ptr + i) == __ldg(r_ptr + i + 1))
          y[i] = T(0);
      }
      return;
    }
    load_table(table, s_off, D);
    const long long slot =
        ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
    // a group's lanes share slot, row and trip counts, so they leave and
    // shuffle together; the mask names the group's lanes only
    if (slot >= n_list) return;
    const int lane = threadIdx.x & (G - 1);
    const unsigned mask =
        (unsigned)((1ull << G) - 1ull) << ((threadIdx.x & 31) & ~(G - 1));
    const long long i = __ldg(r_rows + slot);
    const int b = __ldg(r_ptr + i), e = __ldg(r_ptr + i + 1);
    T acc = T(0);
    for (int c = b; c < e; c += G * kListUnroll) {
      T p[kListUnroll];
#pragma unroll
      for (int u = 0; u < kListUnroll; ++u) {
        const int k = c + u * G + lane;
        p[u] = k < e ? row_term(s_off, r_ids, r_vals, x, i, k, n_cols) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kListUnroll; ++u) {
        const int m = e - c - u * G;  // entries of this round (<= 0: none)
#pragma unroll
        for (int l = 0; l < G; ++l) {
          const T v = __shfl_sync(mask, p[u], l, G);
          if (l < m) acc = add_rn(acc, v);
        }
      }
    }
    if (lane == 0) y[i] = acc;
  } else {
    load_table(table, s_off, D);
    int b[kRowsPerThread], e[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const long long i = i0 + r * kThreads;
      b[r] = e[r] = 0;
      if (i < n_rows) {
        b[r] = __ldg(r_ptr + i);
        e[r] = __ldg(r_ptr + i + 1);
      }
    }
    // the first kRowsUnroll entries of every row are loaded before any is
    // added; a longer row adds the rest in a loop after them
    T p[kRowsPerThread][kRowsUnroll];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u)
        p[r][u] = b[r] + u < e[r] ? row_term(s_off, r_ids, r_vals, x,
                                             i0 + r * kThreads, b[r] + u,
                                             n_cols)
                                  : T(0);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const long long i = i0 + r * kThreads;
      if (i >= n_rows) continue;
      T acc = T(0);
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u)
        if (b[r] + u < e[r]) acc = add_rn(acc, p[r][u]);
      for (int k = b[r] + kRowsUnroll; k < e[r]; ++k)
        acc = add_rn(acc, row_term(s_off, r_ids, r_vals, x, i, k, n_cols));
      y[i] = acc;
    }
  }
}

template <typename T, int G, class Table>
cudaError_t launch_rows_g(const Table& table, const void* r_ptr,
                          const void* r_ids, const void* r_vals,
                          const void* r_rows, const void* x, void* y,
                          long long n_rows, long long n_cols, int D,
                          long long n_list, void* stream) {
  const long long list_blocks =
      G > 1 ? (n_list * G + kThreads - 1) / kThreads : 0;
  const long long per_block = (long long)kThreads * kRowsPerThread;
  const long long blocks = list_blocks + (n_rows + per_block - 1) / per_block;
  if (blocks > 0)
    dia_rows_kernel<T, G, Table>
        <<<(unsigned)blocks, kThreads, D * sizeof(int),
           (cudaStream_t)stream>>>(
            table, (const int*)r_ptr, (const unsigned char*)r_ids,
            (const T*)r_vals, (const int*)r_rows, (const T*)x, (T*)y, n_rows,
            n_cols, D, n_list, (int)list_blocks);
  return cudaGetLastError();
}

template <typename T, class Table>
cudaError_t launch_rows(const Table& table, const void* r_ptr,
                        const void* r_ids, const void* r_vals,
                        const void* r_rows, const void* x, void* y,
                        long long n_rows, long long n_cols, int D,
                        long long n_list, int lanes, void* stream) {
#define HYPRE_ROWS_CASE(G)                                                   \
  case G:                                                                    \
    return launch_rows_g<T, G>(table, r_ptr, r_ids, r_vals, r_rows, x, y,    \
                               n_rows, n_cols, D, n_list, stream);
  switch (lanes) {
    HYPRE_ROWS_CASE(1)
    HYPRE_ROWS_CASE(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef HYPRE_ROWS_CASE
}

template <typename T>
cudaError_t launch_rows_static(const int* offs_host, const void* r_ptr,
                               const void* r_ids, const void* r_vals,
                               const void* r_rows, const void* x, void* y,
                               long long n_rows, long long n_cols, int D,
                               long long n_list, int lanes, void* stream) {
  if (D < 1 || D > kMaxStaticD) return cudaErrorInvalidValue;
  ParamTable table;
  for (int d = 0; d < kMaxStaticD; ++d)
    table.o[d] = d < D ? offs_host[d] : 0;
  return launch_rows<T>(table, r_ptr, r_ids, r_vals, r_rows, x, y, n_rows,
                        n_cols, D, n_list, lanes, stream);
}

}  // namespace

extern "C" {

// offsets: device int32 (D,). Returns cudaGetLastError() after the launch.
int hypre_dia_spmv_f32(const void* dvals, const void* offsets, const void* x,
                       void* y, long long n_rows, long long n_cols, int D,
                       void* stream) {
  return (int)launch_dyn<float>(dvals, offsets, x, y, n_rows, n_cols, D, stream);
}

int hypre_dia_spmv_f64(const void* dvals, const void* offsets, const void* x,
                       void* y, long long n_rows, long long n_cols, int D,
                       void* stream) {
  return (int)launch_dyn<double>(dvals, offsets, x, y, n_rows, n_cols, D, stream);
}

// offs_host: HOST int32 (D,), D in 1..48 or one of 56, 64, 80, 96, copied
// into the kernel's arguments at launch (at most 384 bytes).
int hypre_dia_spmv_static_f32(const void* dvals, const void* offs_host,
                              const void* x, void* y, long long n_rows,
                              long long n_cols, int D, void* stream) {
  return (int)launch_static<float, kMaxStaticD>(
      D, (const int*)offs_host, dvals, x, y, n_rows, n_cols, stream);
}

int hypre_dia_spmv_static_f64(const void* dvals, const void* offs_host,
                              const void* x, void* y, long long n_rows,
                              long long n_cols, int D, void* stream) {
  return (int)launch_static<double, kMaxStaticD>(
      D, (const int*)offs_host, dvals, x, y, n_rows, n_cols, stream);
}

// The row-list route: r_ptr int32 (n_rows + 1), r_ids uint8 and r_vals
// (nnz) in ascending plane order per row, r_rows int32 (n_list) the listed
// rows when lanes > 1 (else unused), lanes 1 or 4.
// offsets: device int32 (D,), D <= 255.
int hypre_dia_rows_f32(const void* r_ptr, const void* r_ids,
                       const void* r_vals, const void* r_rows,
                       const void* offsets, const void* x, void* y,
                       long long n_rows, long long n_cols, int D,
                       long long n_list, int lanes, void* stream) {
  return (int)launch_rows<float>(DeviceTable{(const int*)offsets}, r_ptr,
                                 r_ids, r_vals, r_rows, x, y, n_rows, n_cols,
                                 D, n_list, lanes, stream);
}

int hypre_dia_rows_f64(const void* r_ptr, const void* r_ids,
                       const void* r_vals, const void* r_rows,
                       const void* offsets, const void* x, void* y,
                       long long n_rows, long long n_cols, int D,
                       long long n_list, int lanes, void* stream) {
  return (int)launch_rows<double>(DeviceTable{(const int*)offsets}, r_ptr,
                                  r_ids, r_vals, r_rows, x, y, n_rows,
                                  n_cols, D, n_list, lanes, stream);
}

// offs_host: HOST int32 (D,), D in 1..96, copied into the kernel's
// parameters at launch.
int hypre_dia_rows_static_f32(const void* r_ptr, const void* r_ids,
                              const void* r_vals, const void* r_rows,
                              const void* offs_host, const void* x, void* y,
                              long long n_rows, long long n_cols, int D,
                              long long n_list, int lanes, void* stream) {
  return (int)launch_rows_static<float>((const int*)offs_host, r_ptr, r_ids,
                                        r_vals, r_rows, x, y, n_rows, n_cols,
                                        D, n_list, lanes, stream);
}

int hypre_dia_rows_static_f64(const void* r_ptr, const void* r_ids,
                              const void* r_vals, const void* r_rows,
                              const void* offs_host, const void* x, void* y,
                              long long n_rows, long long n_cols, int D,
                              long long n_list, int lanes, void* stream) {
  return (int)launch_rows_static<double>((const int*)offs_host, r_ptr, r_ids,
                                         r_vals, r_rows, x, y, n_rows,
                                         n_cols, D, n_list, lanes, stream);
}

}  // extern "C"
