// Microbenchmarks of one SM's shared-memory pipe and FMA issue, the two
// limits of the calibration products (csrc/calib_body.cuh, bmm and mm2d).
// Built and run by scpp_tpu_torch/diag/pipe_probe.py; it replaces no TPU
// kernel and no path runs it.
//
// lds: each thread of 256 (8 warps a block, one block an SM, 132 blocks)
// issues 2048 x 16 volatile shared loads of 4, 8 or 16 bytes, every lane
// at its own address, all lanes at one address, or 16 addresses each read
// by two lanes; prints the SM's cycles (clock64) per warp load.
// ffma: each thread runs acc[R][C] += x[r] y[m] from registers, 4096
// times, for the tile shapes of the products; prints warp FMAs issued per
// cycle on the SM (4 is the peak: 128 fp32 lanes).
// icode: the instruction caches. Each warp of 4 (one block an SM) loops
// over N straight-line FFMAs (16 N bytes of code; 8 independent chains, so
// operands never stall issue), all four warps the same code or each its own
// copy (4 x 16 N bytes); prints cycles per warp instruction: 1 while the
// code stays cached, more once it no longer fits.
#include <cstdio>
#include <cuda_runtime.h>

namespace {

constexpr int kBlocks = 132, kThreads = 256;

template <int W>
__device__ __forceinline__ unsigned lds(unsigned a) {
  unsigned x, y, z, w;
  if (W == 4)
    asm volatile("ld.volatile.shared.u32 %0, [%1];" : "=r"(x) : "r"(a));
  else if (W == 8)
    asm volatile("ld.volatile.shared.v2.u32 {%0, %1}, [%2];"
                 : "=r"(x), "=r"(y) : "r"(a));
  else
    asm volatile("ld.volatile.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(x), "=r"(y), "=r"(z), "=r"(w) : "r"(a));
  return x;
}

// PAT 0: lane l at word l W / 4; 1: every lane at word 0; 2: lane l at
// word (l % 16) W / 4
template <int W, int PAT>
__global__ void lds_kernel(int iters, long long* cyc, unsigned* sink) {
  __shared__ __align__(16) unsigned sm[4096];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) sm[i] = i;
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int word = PAT == 0 ? lane * (W / 4)
                   : PAT == 1 ? 0 : (lane % 16) * (W / 4);
  const unsigned base = (unsigned)__cvta_generic_to_shared(sm) + 4 * word;
  unsigned acc = 0;
  __syncthreads();
  const long long c0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 16; ++u) acc ^= lds<W>(base + 1024 * (u & 3));
  }
  __syncthreads();
  const long long c1 = clock64();
  if (threadIdx.x == 0) cyc[blockIdx.x] = c1 - c0;
  if (acc == 0x9e3779b9u) sink[0] = acc;
}

template <int R, int C>
__global__ void ffma_kernel(int iters, long long* cyc, float* sink) {
  float acc[R][C], x[R], y[C];
#pragma unroll
  for (int r = 0; r < R; ++r) x[r] = threadIdx.x * 1e-3f + r;
#pragma unroll
  for (int m = 0; m < C; ++m) y[m] = threadIdx.x * 2e-3f + m;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < C; ++m) acc[r][m] = 0;
  __syncthreads();
  const long long c0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int m = 0; m < C; ++m) acc[r][m] += x[r] * y[m];
  }
  __syncthreads();
  const long long c1 = clock64();
  float s = 0;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < C; ++m) s += acc[r][m];
  if (threadIdx.x == 0) cyc[blockIdx.x] = c1 - c0;
  if (s == 1.2345f) sink[0] = s;
}

template <int N, int COPY>
__device__ __forceinline__ float straight(int iters, float x) {
  float a[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = x + k;
  const float m = 0.999f + COPY * 1e-4f * x, c = 1e-3f * x;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < N / 8; ++u)
#pragma unroll
      for (int k = 0; k < 8; ++k) a[k] = fmaf(a[k], m, c);
  }
  float s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += a[k];
  return s;
}

template <int N, bool COPIES>
__global__ void icode_kernel(int iters, long long* cyc, float* sink) {
  const int w = threadIdx.x / 32;
  const float x = threadIdx.x * 1e-6f;
  __syncthreads();
  const long long c0 = clock64();
  float s;
  if (!COPIES || w == 0)
    s = straight<N, 0>(iters, x);
  else if (w == 1)
    s = straight<N, 1>(iters, x);
  else if (w == 2)
    s = straight<N, 2>(iters, x);
  else
    s = straight<N, 3>(iters, x);
  const long long c1 = clock64();
  if (threadIdx.x % 32 == 0) cyc[blockIdx.x * 4 + w] = c1 - c0;
  if (s == 1.2345f) sink[0] = s;
}

double mean_cycles(long long* cyc) {
  long long h[kBlocks];
  cudaMemcpy(h, cyc, sizeof(h), cudaMemcpyDeviceToHost);
  double c = 0;
  for (long long v : h) c += v;
  return c / kBlocks;
}

template <int W, int PAT>
bool lds_case(const char* name, long long* cyc, void* sink) {
  const int iters = 2048;
  for (int rep = 0; rep < 2; ++rep)
    lds_kernel<W, PAT><<<kBlocks, kThreads>>>(iters, cyc, (unsigned*)sink);
  if (cudaDeviceSynchronize() != cudaSuccess) return false;
  printf("lds %3d-bit %-24s %.2f cycles a warp load\n", 8 * W, name,
         mean_cycles(cyc) / (iters * 16.0 * (kThreads / 32)));
  return true;
}

template <int R, int C>
bool ffma_case(long long* cyc, void* sink) {
  const int iters = 4096;
  for (int rep = 0; rep < 2; ++rep)
    ffma_kernel<R, C><<<kBlocks, kThreads>>>(iters, cyc, (float*)sink);
  if (cudaDeviceSynchronize() != cudaSuccess) return false;
  printf("ffma tile %2d x %-2d %.3f warp FMAs a cycle (peak 4)\n", R, C,
         (double)iters * R * C * (kThreads / 32) / mean_cycles(cyc));
  return true;
}

template <int N, bool COPIES>
bool icode_case(long long* cyc, void* sink) {
  const int iters = 64;
  for (int rep = 0; rep < 2; ++rep)
    icode_kernel<N, COPIES><<<kBlocks, 128>>>(iters, cyc, (float*)sink);
  if (cudaDeviceSynchronize() != cudaSuccess) return false;
  long long h[kBlocks * 4];
  cudaMemcpy(h, cyc, sizeof(h), cudaMemcpyDeviceToHost);
  double c = 0;
  for (long long v : h) c += v;
  printf("icode %3d KB of straight code a warp, %s: %.2f cycles a warp "
         "instruction\n", N * 16 / 1024,
         COPIES ? "each warp its own copy" : "one copy for the 4 warps",
         c / (kBlocks * 4) / ((double)iters * N));
  return true;
}

}  // namespace

int main() {
  long long* cyc;
  void* sink;
  if (cudaMalloc(&cyc, 4 * kBlocks * sizeof(long long)) != cudaSuccess ||
      cudaMalloc(&sink, 16) != cudaSuccess) {
    printf("no CUDA device\n");
    return 1;
  }
  bool ok = lds_case<4, 0>("own address", cyc, sink) &&
            lds_case<4, 1>("one address", cyc, sink) &&
            lds_case<8, 0>("own address", cyc, sink) &&
            lds_case<8, 1>("one address", cyc, sink) &&
            lds_case<8, 2>("16 addresses, 2 lanes each", cyc, sink) &&
            lds_case<16, 0>("own address", cyc, sink) &&
            lds_case<16, 1>("one address", cyc, sink) &&
            lds_case<16, 2>("16 addresses, 2 lanes each", cyc, sink) &&
            ffma_case<6, 6>(cyc, sink) && ffma_case<4, 3>(cyc, sink) &&
            ffma_case<12, 3>(cyc, sink) && ffma_case<12, 6>(cyc, sink) &&
            ffma_case<8, 8>(cyc, sink) && icode_case<256, false>(cyc, sink) &&
            icode_case<512, false>(cyc, sink) &&
            icode_case<1024, false>(cyc, sink) &&
            icode_case<2048, false>(cyc, sink) &&
            icode_case<4096, false>(cyc, sink) &&
            icode_case<256, true>(cyc, sink) &&
            icode_case<512, true>(cyc, sink) &&
            icode_case<1024, true>(cyc, sink) &&
            icode_case<2048, true>(cyc, sink);
  cudaFree(cyc);
  cudaFree(sink);
  if (!ok) printf("FAILED: %s\n", cudaGetErrorString(cudaGetLastError()));
  return ok ? 0 : 1;
}
