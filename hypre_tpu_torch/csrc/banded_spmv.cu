// Banded-ELL sparse products for Hopper (sm_90a), over the operands that
// hypre_tpu_torch/seq/fastmv.py builds:
//
//   gather     y[r] = sum_s vals_t[s, r] * x[starts[r / B] + lcols_t[s, r]]
//              over the slot-major payload (vals_t and lcols_t of shape
//              (k, n_pad), window starts per B-row block)
//   transpose  y[j] = sum over the nonzeros of column j of val * r_in[row]
//              over the transpose schedule (the nonzeros' values and rows
//              sorted by destination column, a column pointer, and a table
//              of chunks cut on column boundaries)
//
// Replaces two TPU kernels of the reference package:
//   - hypre_tpu/seq/fastmv.py::_spmv_kernel (through _banded_call /
//     banded_spmv)                                        -> banded_spmv_kernel
//   - hypre_tpu/seq/fastmv.py::_spmv_t_kernel (through _banded_t_call /
//     banded_spmv_t, the restriction y = P^T r)           -> banded_spmv_t_kernel
//
// What bounds them on this card: device-memory bandwidth. The gather's
// payload is k*n_pad*8 bytes (a value and a column per slot) against 2 flops
// per slot; the transpose schedule is nnz*8 bytes (a value and a row per
// nonzero); x (or y) is n_cols*4 bytes and the output n_rows*4 (or n_cols*4).
//
// What the gather's design does about it: one thread per row, looping over
// the k slots. The slot-major layout puts slot s of 32 consecutive rows in 32
// consecutive words, so every payload load of a warp is one coalesced
// 128-byte line. The x gather is an __ldg through the read-only cache at
// x + starts[r / B] + lcols; the window of a B-row block is narrow (the
// operator is banded), so the lines it touches are shared by the block and
// stay in L1/L2. The TPU needed a one-hot matrix-unit gather with a bf16
// hi/lo split because Mosaic has no gather; none of that is carried over:
// the gather here is exact f32.
//
// The transpose: TPU grid steps ran one after another, so each 1024-row
// block's window of y could be read-modified-written in turn. Blocks here
// run at once, and scattering with atomic adds is bound by the count of
// atomics the L2 resolves (and changes the last bits from run to run). So
// the scatter is sorted once, when the operator is optimized, and the kernel
// owns its outputs: one block per chunk of the schedule streams the chunk's
// contiguous (value, row) pairs with 16-byte coalesced loads, multiplies by
// r_in[row] through the read-only path (the rows of a chunk lie in a narrow
// band and hit L1/L2), leaves the products in shared memory, and then sums
// each column's segment in a fixed order and stores y[j] once: no atomics,
// no zero fill (a column without nonzeros gets 0), the same bits every run.
// The loads go straight to registers: eight blocks of 256 threads per SM
// keep enough of them in flight, and the payload is loaded as streaming so
// that r_in stays cached. Segments are summed by one thread per column
// while a chunk's mean segment length is at most 32, by 2 to 32 lanes per
// column with a shuffle tree above that; the lane count is picked per
// chunk. A column longer than a chunk closes its chunk and is summed by the
// whole block in a fixed tree.

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

// ---- transpose ------------------------------------------------------------

constexpr int kTThreads = 256;
constexpr int kTWarps = kTThreads / 32;
// entries a lane sums in turn before more lanes share a column: one thread
// per column is the fastest on this card up to about this mean length
constexpr int kTPerLane = 32;

// Sums the segments of columns [c0, c1) out of prod (indexed from slot p0a of
// the schedule), G lanes per column: each lane adds every G-th entry in
// turn, then a xor-shuffle tree, whose order is fixed and leaves the same
// bits in every lane.
template <int G>
__device__ __forceinline__ void reduce_segments(
    const float* __restrict__ prod, const int* __restrict__ colptr,
    float* __restrict__ y, int c0, int c1, int p0a) {
  constexpr int kPerWarp = 32 / G;
  const int warp = threadIdx.x >> 5;
  const int group = (threadIdx.x & 31) / G;
  const int lane = threadIdx.x & (G - 1);
  // the trip count is the same for all lanes of a warp (full-mask shuffles)
  for (int jb = c0 + warp * kPerWarp; jb < c1; jb += kTWarps * kPerWarp) {
    const int j = jb + group;
    const bool live = j < c1;
    int b = 0, e = 0;
    if (live) {
      b = __ldg(colptr + j) - p0a;
      e = __ldg(colptr + j + 1) - p0a;
    }
    float acc = 0.f;
    for (int i = b + lane; i < e; i += G) acc = __fadd_rn(acc, prod[i]);
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (live && lane == 0) y[j] = acc;
  }
}

// One block per chunk: columns [chunks[c], chunks[c+1]). slots is the
// capacity of prod in entries (2 * cap). All columns of a chunk start inside
// one run of cap nonzeros, so all but the last column hold fewer than cap
// entries together; when the whole chunk does not fit, its last column is
// longer than cap and goes through the block-wide sum below.
__global__ void __launch_bounds__(kTThreads)
banded_spmv_t_kernel(const float* __restrict__ t_vals,
                     const int* __restrict__ t_rows,
                     const int* __restrict__ colptr,
                     const int* __restrict__ chunks,
                     const float* __restrict__ r_in, float* __restrict__ y,
                     int slots) {
  extern __shared__ __align__(16) float prod[];
  __shared__ float part[kTWarps];
  const int c0 = __ldg(chunks + blockIdx.x);
  const int c1 = __ldg(chunks + blockIdx.x + 1);
  const int p0 = __ldg(colptr + c0), p1 = __ldg(colptr + c1);
  const int p0a = p0 & ~3;  // 16-byte loads: start at a multiple of 4 slots
  const bool overflow = ((p1 + 3) & ~3) - p0a > slots;
  const int cf = overflow ? c1 - 1 : c1;  // columns summed from prod
  const int pf = overflow ? __ldg(colptr + cf) : p1;
  const int n4 = (((pf + 3) & ~3) - p0a) >> 2;
  // slots before p0 belong to the previous chunk and slots from pf up to the
  // next multiple of 4 to the next column or the zero padding: their
  // products land in prod and no segment reads them
  const float4* v4 = reinterpret_cast<const float4*>(t_vals + p0a);
  const int4* r4 = reinterpret_cast<const int4*>(t_rows + p0a);
  float4* prod4 = reinterpret_cast<float4*>(prod);
#pragma unroll 2
  for (int q = threadIdx.x; q < n4; q += kTThreads) {
    // read once: streaming loads, so r_in keeps its place in the caches
    const float4 v = __ldcs(v4 + q);
    const int4 rr = __ldcs(r4 + q);
    float4 p;
    p.x = __fmul_rn(v.x, __ldg(r_in + rr.x));
    p.y = __fmul_rn(v.y, __ldg(r_in + rr.y));
    p.z = __fmul_rn(v.z, __ldg(r_in + rr.z));
    p.w = __fmul_rn(v.w, __ldg(r_in + rr.w));
    prod4[q] = p;
  }
  __syncthreads();

  // lanes per column from the chunk's mean segment length: the smallest
  // power of two that leaves a lane at most kTPerLane entries
  const long long room = (long long)(cf - c0) * kTPerLane;
  const int nnz = pf - p0;
  if (nnz <= room)
    reduce_segments<1>(prod, colptr, y, c0, cf, p0a);
  else if (nnz <= 2 * room)
    reduce_segments<2>(prod, colptr, y, c0, cf, p0a);
  else if (nnz <= 4 * room)
    reduce_segments<4>(prod, colptr, y, c0, cf, p0a);
  else if (nnz <= 8 * room)
    reduce_segments<8>(prod, colptr, y, c0, cf, p0a);
  else if (nnz <= 16 * room)
    reduce_segments<16>(prod, colptr, y, c0, cf, p0a);
  else
    reduce_segments<32>(prod, colptr, y, c0, cf, p0a);

  if (overflow) {
    // the long column [pf, p1): every thread adds every kTThreads-th
    // product in turn, then a shuffle tree per warp and the warps' sums in
    // order
    float acc = 0.f;
    for (int i = pf + threadIdx.x; i < p1; i += kTThreads)
      acc = __fadd_rn(acc, __fmul_rn(__ldg(t_vals + i),
                                     __ldg(r_in + __ldg(t_rows + i))));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = part[0];
      for (int w = 1; w < kTWarps; ++w) sum = __fadd_rn(sum, part[w]);
      y[cf] = sum;
    }
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

// The transpose schedule of fastmv.with_transpose_schedule: t_vals and
// t_rows (16-byte aligned, padded to a multiple of 4 slots), colptr
// (n_cols + 1), chunks (n_chunks + 1), cap as the schedule was cut with.
// r_in: (n_rows,) f32; y: (n_cols,) f32, every entry written.
int hypre_banded_spmv_t(const void* t_vals, const void* t_rows,
                        const void* colptr, const void* chunks,
                        const void* r_in, void* y, long long n_chunks,
                        int cap, void* stream) {
  const int slots = 2 * cap;
  const size_t smem = (size_t)slots * sizeof(float);
  if (n_chunks > 0)
    banded_spmv_t_kernel<<<(unsigned)n_chunks, kTThreads, smem,
                           (cudaStream_t)stream>>>(
        (const float*)t_vals, (const int*)t_rows, (const int*)colptr,
        (const int*)chunks, (const float*)r_in, (float*)y, slots);
  return (int)cudaGetLastError();
}

}  // extern "C"
