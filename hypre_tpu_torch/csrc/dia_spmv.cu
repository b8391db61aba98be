// DIA sparse matrix-vector product for Hopper (sm_90a):
//
//     y[i] = sum_d dvals[d, i] * x[i + offsets[d]],   x read as 0 outside [0, n_cols)
//
// Replaces two TPU kernels of the reference package:
//   - hypre_tpu/seq/dia.py::_dia_kernel (offsets in a device array, reached
//     through _dia_pallas_call / dia_spmv_pallas)       -> dia_dyn_kernel,
//                                                          dia_rows_kernel
//   - hypre_tpu/seq/dia.py::_dia_kernel_static (offsets fixed at compile time,
//     _dia_pallas_call_static / dia_spmv_pallas_static) -> dia_static_kernel<T, D>
//     (on mostly-zero planes it too runs dia_rows_kernel: see below)
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
// layout of the same planes, for planes that are mostly zero: the D = 64
// fine-space transfer planes of a TransferDia (~2 % nonzeros) and the D = 2
// coupling view U of a semi-structured matrix (2048 nonzeros over 2.1 M
// rows). seq/dia.py::compact_dia builds it once per operator: the non-empty
// rows, ascending, with a pointer over that list and their nonzeros in
// ascending plane order; when listing rows would cost more bytes than a
// pointer per row (P: every row holds an entry), every row is listed and
// the list is implicit. Rows off an explicit list get their zero in the
// same launch from a pass over a bitmask of the listed rows (n/8 bytes,
// one word for a warp's 32 rows), which reads no pointer per row: a
// bitmask because the zero pass then costs y's bytes and 1/32 more, where
// a per-row pointer cost 4 bytes a row (U: 8.4 MB of pointers for 2048
// nonzeros). The dense kernels stream all D*n values; this one moves the
// layout, y, and x at the columns the layout reaches. It is bound by those
// bytes and by the latency of the chain of dependent loads (list slot ->
// row pointer -> plane id -> offset -> x), so every thread keeps several
// chains in flight. An entry names its column by a uint8 plane id through
// the offset table in shared memory: an int32 column per entry (one link
// shorter, 3 bytes more) was timed too and was the slower on P and P^T
// (PERF.md). Kernel 2's offsets compiled in would specialize
// nothing here (the plane id is data), so a static operator takes the
// same kernel. Two schedules, picked
// once per operator from the mean length of the listed rows:
//   - lanes == 1: a thread sums whole rows (P: 1-4 entries a row; U: 1), so
//     a warp's pointer, index and value loads are nearly contiguous.
//   - lanes == 4: a group of 4 lanes loads 4 entries of one row at a time
//     (P^T: ~6 % of the rows, ~25 entries each) and its sum is taken IN
//     ENTRY ORDER, one shuffled product after the other, so the loads are
//     parallel and the order of the adds is that of one thread.
// Every y is written once, no atomics. Skipping a zero term changes no bit
// of the sum for finite x: the accumulator starts at +0 and never becomes
// -0, and acc + (+-0) == acc. So the row-list kernel agrees bit for bit
// with the dense kernels and their plain versions.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Static instantiations: every D up to try_dia's max_offsets, and above it
// the values that TransferDia pads its diagonal count to (the setup's width
// ladder up to probe_transfer_offsets' limit).
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
// Row-list route: one kernel, offsets from the device (kernel 2's row-list
// entry folded into kernel 1's: the plane id of an entry is data, so the
// offset table is read at a run-time index whatever the offsets are).
// ---------------------------------------------------------------------------

// One term of a listed row: the plane id of entry k names its offset in
// the block's shared-memory copy of the offset table.
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

// Loads in flight. One thread a listed row: kSlotsPerThread rows a thread,
// the first kSlotUnroll entries of each loaded before the first is added.
// Lane groups: kGroupUnroll rounds of G entries a row loaded before they
// are added (4 a lane; the earlier list kernel kept 2). Zero pass:
// kZeroRowsPerThread rows a thread. (Chosen by tune_dia_rows.py on an
// H100 at the main path's shapes: 4 rows a thread were slower than 2 on
// P, where the rows hold 1.5 entries, and a floor of resident blocks
// changed nothing.)
constexpr int kSlotsPerThread = 2;
constexpr int kSlotUnroll = 4;
constexpr int kGroupUnroll = 4;
constexpr int kZeroRowsPerThread = 4;

// Blocks [0, list_blocks) sum the listed rows: slot s of the list is row
// r_rows[s] (Listed), or row s (every row listed, r_rows unread), its
// entries [r_ptr[s], r_ptr[s+1]). The blocks after them (Listed only)
// write the zero of every row whose bit in r_mask is clear; a warp's 32
// rows share one mask word, so that pass reads n/8 bytes and no row
// pointer.
template <typename T, int G, bool Listed>
__global__ void __launch_bounds__(kThreads)
dia_rows_kernel(const int* __restrict__ offsets,
                const int* __restrict__ r_rows, const int* __restrict__ r_ptr,
                const unsigned char* __restrict__ r_ids,
                const T* __restrict__ r_vals,
                const unsigned* __restrict__ r_mask, const T* __restrict__ x,
                T* __restrict__ y, long long n_rows, long long n_cols, int D,
                long long n_list, int list_blocks) {
  extern __shared__ int s_off[];
  if (Listed && (int)blockIdx.x >= list_blocks) {
    const long long i0 = ((long long)blockIdx.x - list_blocks) * kThreads *
                             kZeroRowsPerThread + threadIdx.x;
#pragma unroll
    for (int r = 0; r < kZeroRowsPerThread; ++r) {
      const long long i = i0 + (long long)r * kThreads;
      if (i < n_rows && !((__ldg(r_mask + (i >> 5)) >> (i & 31)) & 1u))
        y[i] = T(0);
    }
    return;
  }
  for (int d = threadIdx.x; d < D; d += kThreads) s_off[d] = __ldg(offsets + d);
  __syncthreads();
  if constexpr (G > 1) {
    const long long slot =
        ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
    // a group's lanes share slot, row and trip counts, so they leave and
    // shuffle together; the mask names the group's lanes only
    if (slot >= n_list) return;
    const int lane = threadIdx.x & (G - 1);
    const unsigned mask =
        (unsigned)((1ull << G) - 1ull) << ((threadIdx.x & 31) & ~(G - 1));
    const long long i = Listed ? __ldg(r_rows + slot) : slot;
    const int b = __ldg(r_ptr + slot), e = __ldg(r_ptr + slot + 1);
    T acc = T(0);
    for (int c = b; c < e; c += G * kGroupUnroll) {
      T p[kGroupUnroll];
#pragma unroll
      for (int u = 0; u < kGroupUnroll; ++u) {
        const int k = c + u * G + lane;
        p[u] = k < e ? row_term(s_off, r_ids, r_vals, x, i, k, n_cols) : T(0);
      }
      // the sum in entry order: one shuffled product after the other
#pragma unroll
      for (int u = 0; u < kGroupUnroll; ++u) {
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
    const long long s0 =
        (long long)blockIdx.x * kThreads * kSlotsPerThread + threadIdx.x;
    long long row[kSlotsPerThread];
    int b[kSlotsPerThread], e[kSlotsPerThread];
#pragma unroll
    for (int r = 0; r < kSlotsPerThread; ++r) {
      const long long s = s0 + (long long)r * kThreads;
      row[r] = -1;
      b[r] = e[r] = 0;
      if (s < n_list) {
        row[r] = Listed ? __ldg(r_rows + s) : s;
        b[r] = __ldg(r_ptr + s);
        e[r] = __ldg(r_ptr + s + 1);
      }
    }
    T p[kSlotsPerThread][kSlotUnroll];
#pragma unroll
    for (int r = 0; r < kSlotsPerThread; ++r)
#pragma unroll
      for (int u = 0; u < kSlotUnroll; ++u)
        p[r][u] = b[r] + u < e[r] ? row_term(s_off, r_ids, r_vals, x, row[r],
                                             b[r] + u, n_cols)
                                  : T(0);
#pragma unroll
    for (int r = 0; r < kSlotsPerThread; ++r) {
      if (row[r] < 0) continue;
      T acc = T(0);
#pragma unroll
      for (int u = 0; u < kSlotUnroll; ++u)
        if (b[r] + u < e[r]) acc = add_rn(acc, p[r][u]);
      for (int k = b[r] + kSlotUnroll; k < e[r]; ++k)
        acc = add_rn(acc, row_term(s_off, r_ids, r_vals, x, row[r], k, n_cols));
      y[row[r]] = acc;
    }
  }
}

template <typename T, int G, bool Listed>
cudaError_t launch_rows_g(const void* r_rows, const void* r_ptr,
                          const void* r_ids, const void* r_vals,
                          const void* r_mask, const void* offsets,
                          const void* x, void* y, long long n_rows,
                          long long n_cols, int D, long long n_list,
                          void* stream) {
  const long long per_block = G > 1 ? kThreads / G
                                    : (long long)kThreads * kSlotsPerThread;
  const long long list_blocks = (n_list + per_block - 1) / per_block;
  const long long zero_rows = (long long)kThreads * kZeroRowsPerThread;
  const long long blocks =
      list_blocks + (Listed ? (n_rows + zero_rows - 1) / zero_rows : 0);
  if (blocks > 0)
    dia_rows_kernel<T, G, Listed>
        <<<(unsigned)blocks, kThreads, D * sizeof(int),
           (cudaStream_t)stream>>>(
            (const int*)offsets, (const int*)r_rows, (const int*)r_ptr,
            (const unsigned char*)r_ids, (const T*)r_vals,
            (const unsigned*)r_mask, (const T*)x, (T*)y, n_rows, n_cols, D,
            n_list, (int)list_blocks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const void* r_rows, const void* r_ptr,
                        const void* r_ids, const void* r_vals,
                        const void* r_mask, const void* offsets,
                        const void* x, void* y, long long n_rows,
                        long long n_cols, int D, long long n_list, int lanes,
                        void* stream) {
  if ((r_rows == nullptr) != (r_mask == nullptr) ||
      (r_rows == nullptr && n_list != n_rows))
    return cudaErrorInvalidValue;
#define HYPRE_ROWS_CASE(G)                                                    \
  return r_rows ? launch_rows_g<T, G, true>(r_rows, r_ptr, r_ids, r_vals,     \
                                            r_mask, offsets, x, y, n_rows,    \
                                            n_cols, D, n_list, stream)        \
                : launch_rows_g<T, G, false>(r_rows, r_ptr, r_ids, r_vals,    \
                                             r_mask, offsets, x, y, n_rows,   \
                                             n_cols, D, n_list, stream);
  if (lanes == 1) HYPRE_ROWS_CASE(1)
  if (lanes == 4) HYPRE_ROWS_CASE(4)
#undef HYPRE_ROWS_CASE
  return cudaErrorInvalidValue;
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

// The row-list route (seq/dia.py::compact_dia builds the layout): r_rows
// int32 (n_list) the listed rows, ascending, and r_mask int32 (ceil(n/32))
// their bits, both null when every row is listed (n_list == n_rows);
// r_ptr int32 (n_list + 1) over the list; r_ids uint8 plane ids and r_vals
// (nnz) in ascending plane order per row; offsets device int32 (D,),
// D <= 255; lanes 1 or 4.
int hypre_dia_rows_f32(const void* r_rows, const void* r_ptr,
                       const void* r_ids, const void* r_vals,
                       const void* r_mask, const void* offsets,
                       const void* x, void* y, long long n_rows,
                       long long n_cols, int D, long long n_list, int lanes,
                       void* stream) {
  return (int)launch_rows<float>(r_rows, r_ptr, r_ids, r_vals, r_mask,
                                 offsets, x, y, n_rows, n_cols, D, n_list,
                                 lanes, stream);
}

int hypre_dia_rows_f64(const void* r_rows, const void* r_ptr,
                       const void* r_ids, const void* r_vals,
                       const void* r_mask, const void* offsets,
                       const void* x, void* y, long long n_rows,
                       long long n_cols, int D, long long n_list, int lanes,
                       void* stream) {
  return (int)launch_rows<double>(r_rows, r_ptr, r_ids, r_vals, r_mask,
                                  offsets, x, y, n_rows, n_cols, D, n_list,
                                  lanes, stream);
}

}  // extern "C"
