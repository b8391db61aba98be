// Banded-ELL sparse products for Hopper (sm_90a), over the slot-major
// payload that hypre_tpu_torch/seq/fastmv.py builds (vals_t and lcols_t of
// shape (k, n_pad), window starts per B-row block):
//
//   gather     y[r] = sum_s vals_t[s, r] * x[starts[r / B] + lcols_t[s, r]]
//   transpose  y[starts[r / B] + lcols_t[s, r]] += vals_t[s, r] * r_in[r]
//
// Replaces two TPU kernels of the reference package:
//   - hypre_tpu/seq/fastmv.py::_spmv_kernel (through _banded_call /
//     banded_spmv)                                        -> banded_spmv_kernel
//   - hypre_tpu/seq/fastmv.py::_spmv_t_kernel (through _banded_t_call /
//     banded_spmv_t, the restriction y = P^T r)           -> banded_spmv_t_kernel
//
// What bounds them on this card: device-memory bandwidth. The payload is
// k*n_pad*8 bytes (a value and a column per slot) against 2 flops per slot;
// x (or y) is n_cols*4 bytes and the output n_rows*4 (or n_cols*4).
//
// What the design does about it: one thread per row, looping over the k
// slots. The slot-major layout puts slot s of 32 consecutive rows in 32
// consecutive words, so every payload load of a warp is one coalesced
// 128-byte line. The x gather is an __ldg through the read-only cache at
// x + starts[r / B] + lcols; the window of a B-row block is narrow (the
// operator is banded), so the lines it touches are shared by the block and
// stay in L1/L2. The TPU needed a one-hot matrix-unit gather with a bf16
// hi/lo split because Mosaic has no gather; none of that is carried over:
// the gather here is exact f32.
//
// The transpose: TPU grid steps ran one after another, so each block's
// window could be read-modified-written in turn. Blocks here run at once and
// neighbouring windows overlap, so contributions go into a zeroed output by
// atomicAdd on f32. The order of the adds, and so the last bits of the
// result, change from run to run; a deterministic two-pass version is later
// work. Slots with value 0 (padding) add nothing and are skipped.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
banded_spmv_kernel(const float* __restrict__ vals_t,
                   const int* __restrict__ lcols_t,
                   const int* __restrict__ starts,
                   const float* __restrict__ x, float* __restrict__ y,
                   long long n_pad, long long n_rows, long long n_x, int k,
                   int B) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const long long base = __ldg(starts + r / B);
  float acc = 0.f;
  for (int s = 0; s < k; ++s) {
    const long long idx = (long long)s * n_pad + r;
    const float v = __ldg(vals_t + idx);
    const long long j = base + __ldg(lcols_t + idx);
    const float xv = (j >= 0 && j < n_x) ? __ldg(x + j) : 0.f;
    // rounded separately, in slot order: equal to the plain version
    acc = __fadd_rn(acc, __fmul_rn(v, xv));
  }
  y[r] = acc;
}

__global__ void __launch_bounds__(kThreads)
banded_spmv_t_kernel(const float* __restrict__ vals_t,
                     const int* __restrict__ lcols_t,
                     const int* __restrict__ starts,
                     const float* __restrict__ r_in, float* __restrict__ y,
                     long long n_pad, long long n_rows, long long n_out, int k,
                     int B) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const float rv = __ldg(r_in + r);
  const long long base = __ldg(starts + r / B);
  for (int s = 0; s < k; ++s) {
    const long long idx = (long long)s * n_pad + r;
    const float v = __ldg(vals_t + idx);
    if (v == 0.f) continue;
    const long long j = base + __ldg(lcols_t + idx);
    if (j >= 0 && j < n_out) atomicAdd(y + j, __fmul_rn(v, rv));
  }
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// x: (n_x,) f32; y: (n_rows,) f32. Returns cudaGetLastError().
int hypre_banded_spmv(const void* vals_t, const void* lcols_t,
                      const void* starts, const void* x, void* y,
                      long long n_pad, long long n_rows, long long n_x, int k,
                      int B, void* stream) {
  if (n_rows > 0)
    banded_spmv_kernel<<<blocks_for(n_rows), kThreads, 0,
                         (cudaStream_t)stream>>>(
        (const float*)vals_t, (const int*)lcols_t, (const int*)starts,
        (const float*)x, (float*)y, n_pad, n_rows, n_x, k, B);
  return (int)cudaGetLastError();
}

// r_in: (n_rows,) f32; y: (n_out,) f32, ZEROED by the caller.
int hypre_banded_spmv_t(const void* vals_t, const void* lcols_t,
                        const void* starts, const void* r_in, void* y,
                        long long n_pad, long long n_rows, long long n_out,
                        int k, int B, void* stream) {
  if (n_rows > 0)
    banded_spmv_t_kernel<<<blocks_for(n_rows), kThreads, 0,
                           (cudaStream_t)stream>>>(
        (const float*)vals_t, (const int*)lcols_t, (const int*)starts,
        (const float*)r_in, (float*)y, n_pad, n_rows, n_out, k, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
