// DIA sparse matrix-vector product for Hopper (sm_90a):
//
//     y[i] = sum_d dvals[d, i] * x[i + offsets[d]],   x read as 0 outside [0, n_cols)
//
// Replaces two TPU kernels of the reference package:
//   - hypre_tpu/seq/dia.py::_dia_kernel (offsets in a device array, reached
//     through _dia_pallas_call / dia_spmv_pallas)       -> dia_dyn_kernel
//   - hypre_tpu/seq/dia.py::_dia_kernel_static (offsets fixed at compile time,
//     _dia_pallas_call_static / dia_spmv_pallas_static) -> dia_static_kernel<T, D>
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

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStaticD = 48;  // try_dia's max_offsets

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

// Finds the instantiation for the run-time diagonal count by recursion
// from kMaxStaticD down to 1.
template <typename T, int D>
cudaError_t launch_static(int want, const int* offs_host, const void* dvals,
                          const void* x, void* y, long long n_rows,
                          long long n_cols, void* stream) {
  if constexpr (D == 0) {
    return cudaErrorInvalidValue;
  } else {
    if (want != D)
      return launch_static<T, D - 1>(want, offs_host, dvals, x, y, n_rows,
                                     n_cols, stream);
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

// offs_host: HOST int32 (D,), 1 <= D <= 48, copied into the kernel's
// arguments at launch.
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

}  // extern "C"
