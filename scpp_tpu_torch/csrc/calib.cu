// Calibration probes for Hopper (sm_90a).
//
// Replaces the TPU calibration kernels of tools/diag/: the loop kernel of
// mono_calib.py:run_loop_kernel (bodies A1-G), its VMEM probe F, and the
// single-construct kernels of mono_probe.py:bench. Each __global__ below
// runs one function of scpp_tpu_torch/diag/calib.py `iters` dependent
// steps inside one launch, as the TPU kernels loop inside the kernel; the
// arithmetic is in calib_body.cuh, the plain versions in diag/calib.py.
// They measure the building blocks of the monolithic IPM kernel on this
// card: a 48-column rank-1 sweep, batched 48- and 96-wide products, FMA
// matvecs, elementwise passes, strided rows, and the shared-memory ceiling.
//
// What bounds them: the sweeps, matvecs and the other simple bodies are
// bound by operations (fp32 FMA loops through shared memory, no tensor
// cores: TF32 stays off) and, in their simple versions, by one block per
// matrix and a barrier per sweep column; the elementwise probes and the
// copies by bytes. Each block keeps its matrix in shared memory for the
// whole loop, and every launch sets the dynamic shared memory it asks for
// (a (96, 96) product needs 110.6 KB in float32, above the 48 KB a block
// gets without opting in). Making those fast is not their purpose:
// chip_smoke.py and diag/mono_calib.py print each one's time beside its
// bound.
//
// The two products, bmm and mm2d, price what a 48- or 96-wide fp32
// product costs on one SM, and are built for it. Their dependent steps
// keep one matrix (or one set of rows) on one SM, so the least time is
// FMA issue on that SM: 50 steps of a 96 x 96 product are 884,736 FMAs a
// step, 0.175 ms at 128 FMAs a cycle. What bounds them below that is the
// shared-memory pipe that feeds the operands (128 bytes a cycle to the
// lanes), then load latency with one warp a scheduler, and a barrier a
// step. The design (calib_body.cuh): each thread keeps a tile of the
// outputs in registers for the whole loop and reads one k's operands as
// 8- or 16-byte vectors, a pair of k or two ahead of their FMAs, in a
// branch-free k loop of 16 k (bmm) or 48 k (mm2d) a pass. bmm: 6 x 6
// tiles (256 threads at w = 96, 64 at w = 48, one matrix a block, so the
// 240 matrices of w = 48 are all resident at once); Bm = a + s acc is
// double-buffered in shared memory, so a step costs one barrier. mm2d: a
// row's step needs only that row, so a warp owns 4 rows (a lane 4 rows x
// 3 columns), publishes its X = a + acc with __syncwarp alone, and no
// block barrier runs in the loop; top = a[:w] is copied in once with
// cp.async; 16 rows a block give 120 blocks for the 1920 rows.
//
// Interface: plain C functions, loaded with ctypes; each launches on the
// given stream, allocates nothing, and returns the cudaError_t of the
// launch (or cudaErrorInvalidValue for arguments it does not take). A
// refused shared-memory request is cleared from the error state before it
// is returned, so no later launch check reports it.

#include <cuda_runtime.h>

#include "calib_body.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMvThreads = 128;   // one thread per matvec output (<= 128)

template <typename T>
__global__ void __launch_bounds__(kThreads)
ew_kernel(long long n, const T* a, T* out, int iters) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) calib::ew_item<T>(i, a, out, iters);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_sweep_kernel(int w, int masked, const T* a, T* out, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long off = (long long)blockIdx.x * w * w;
  calib::chol_sweep_block<T>(w, masked != 0, a + off, out + off, iters,
                             reinterpret_cast<T*>(smem_raw));
}

template <typename T>
__global__ void __launch_bounds__(calib::kBmmMaxThreads)
bmm_kernel(int w, T s, const T* a, T* out, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long off = (long long)blockIdx.x * w * w;
  calib::bmm_block<T>(w, s, a + off, out + off, iters,
                      reinterpret_cast<T*>(smem_raw));
}

template <typename T>
__global__ void __launch_bounds__(calib::kMmThreads)
mm2d_kernel(int rows, int w, const T* a, T* out, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  calib::mm2d_block<T>(rows, w, blockIdx.x * calib::kMmRowsPerBlock, a, out,
                       iters, reinterpret_cast<T*>(smem_raw));
}

template <typename T>
__global__ void __launch_bounds__(kMvThreads)
matvec_kernel(int R, int C, int trans, T s, const T* a, const T* v, T* out,
              int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long b = blockIdx.x;
  const int O = trans ? R : C, Kc = trans ? C : R;
  calib::matvec_block<T>(R, C, trans != 0, s, a + b * R * C, v + b * Kc,
                         out + b * O, iters, reinterpret_cast<T*>(smem_raw));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rank1_kernel(int w, const T* a, T* out, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long off = (long long)blockIdx.x * w * w;
  calib::rank1_block<T>(w, a + off, out + off, iters,
                        reinterpret_cast<T*>(smem_raw));
}

template <typename T>
__global__ void __launch_bounds__(kMvThreads)
chol8flat_kernel(int n, const T* M0, T* out, int iters) {
  const long long row = (long long)blockIdx.x * kMvThreads + threadIdx.x;
  if (row < n) calib::chol8flat_item<T>(row, M0, out, iters);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
transpose_kernel(int w, const T* a, T* out, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long off = (long long)blockIdx.x * w * w;
  calib::transpose_block<T>(w, a + off, out + off, iters,
                            reinterpret_cast<T*>(smem_raw));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
reshape88_kernel(long long n, const T* a, T* out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) calib::reshape88_item<T>(i, a, out);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
slice_mix_kernel(int w, const T* a, T* out, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long off = (long long)blockIdx.x * w * w;
  calib::slice_mix_block<T>(w, a + off, out + off, iters,
                            reinterpret_cast<T*>(smem_raw));
}

// the VMEM probe's counterpart: one block with `words` floats of dynamic
// shared memory writes its first and last word and returns their sum
__global__ void smem_probe_kernel(long long words, float* out) {
  extern __shared__ __align__(16) float buf[];
  if (threadIdx.x == 0) {
    buf[0] = 1.0f;
    buf[words - 1] = 2.0f;
  }
  __syncthreads();
  if (threadIdx.x == 0) out[0] = buf[0] + buf[words - 1];
}

// Opt the kernel into `smem` bytes of dynamic shared memory where that is
// above the default 48 KB, launch it, and return the launch's error.
template <typename... KArgs, typename... Args>
int go(void (*kernel)(KArgs...), long long grid, int threads, size_t smem,
       void* stream, Args... args) {
  if (grid < 1 || grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  kernel<<<(unsigned)grid, threads, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

long long blocks_of(long long n, int per) { return (n + per - 1) / per; }

}  // namespace

#define CALIB_DISPATCH(CALL)                                 \
  if (elem_bytes == 4) {                                     \
    using T = float;                                         \
    return CALL;                                             \
  }                                                          \
  if (elem_bytes == 8) {                                     \
    using T = double;                                        \
    return CALL;                                             \
  }                                                          \
  return (int)cudaErrorInvalidValue;

extern "C" int calib_ew(int elem_bytes, void* stream, long long n,
                        const void* a, void* out, int iters) {
  CALIB_DISPATCH(go(ew_kernel<T>, blocks_of(n, kThreads), kThreads, 0,
                    stream, n, (const T*)a, (T*)out, iters))
}

extern "C" int calib_chol_sweep(int elem_bytes, void* stream, int n, int w,
                                int masked, const void* a, void* out,
                                int iters) {
  if (w < 1) return (int)cudaErrorInvalidValue;
  CALIB_DISPATCH(go(chol_sweep_kernel<T>, n, kThreads,
                    sizeof(T) * (w * w + w), stream, w, masked, (const T*)a,
                    (T*)out, iters))
}

extern "C" int calib_bmm(int elem_bytes, void* stream, int n, int w,
                         double s, const void* a, void* out, int iters) {
  if (w < 1 || w > calib::kBmmMaxWidth) return (int)cudaErrorInvalidValue;
  CALIB_DISPATCH(go(bmm_kernel<T>, n, calib::bmm_threads(w),
                    sizeof(T) * calib::bmm_smem(w), stream, w, (T)s,
                    (const T*)a, (T*)out, iters))
}

extern "C" int calib_mm2d(int elem_bytes, void* stream, int rows, int w,
                          const void* a, void* out, int iters) {
  if (w < 1 || w > calib::kMmMaxWidth || rows < w)
    return (int)cudaErrorInvalidValue;
  CALIB_DISPATCH(go(mm2d_kernel<T>, blocks_of(rows, calib::kMmRowsPerBlock),
                    calib::kMmThreads, sizeof(T) * calib::mm2d_smem(w),
                    stream, rows, w, (const T*)a, (T*)out, iters))
}

extern "C" int calib_matvec(int elem_bytes, void* stream, int n, int R, int C,
                            int trans, double s, const void* a,
                            const void* v, void* out, int iters) {
  if (R < 1 || C < 1 || (trans ? R : C) > kMvThreads)
    return (int)cudaErrorInvalidValue;
  CALIB_DISPATCH(go(matvec_kernel<T>, n, kMvThreads,
                    sizeof(T) * (R * C + (trans ? C : R)), stream, R, C,
                    trans, (T)s, (const T*)a, (const T*)v, (T*)out, iters))
}

extern "C" int calib_rank1(int elem_bytes, void* stream, int n, int w,
                           const void* a, void* out, int iters) {
  if (w < 1) return (int)cudaErrorInvalidValue;
  CALIB_DISPATCH(go(rank1_kernel<T>, n, kThreads, sizeof(T) * (w * w + w),
                    stream, w, (const T*)a, (T*)out, iters))
}

extern "C" int calib_chol8flat(int elem_bytes, void* stream, int n,
                               const void* M0, void* out, int iters) {
  CALIB_DISPATCH(go(chol8flat_kernel<T>, blocks_of(n, kMvThreads),
                    kMvThreads, 0, stream, n, (const T*)M0, (T*)out, iters))
}

extern "C" int calib_transpose(int elem_bytes, void* stream, int n, int w,
                               const void* a, void* out, int iters) {
  if (w < 1) return (int)cudaErrorInvalidValue;
  CALIB_DISPATCH(go(transpose_kernel<T>, n, kThreads, sizeof(T) * 3 * w * w,
                    stream, w, (const T*)a, (T*)out, iters))
}

extern "C" int calib_reshape88(int elem_bytes, void* stream, long long n,
                               const void* a, void* out) {
  CALIB_DISPATCH(go(reshape88_kernel<T>, blocks_of(n, kThreads), kThreads, 0,
                    stream, n, (const T*)a, (T*)out))
}

extern "C" int calib_slice_mix(int elem_bytes, void* stream, int n, int w,
                               const void* a, void* out, int iters) {
  if (w < 8) return (int)cudaErrorInvalidValue;
  CALIB_DISPATCH(go(slice_mix_kernel<T>, n, kThreads, sizeof(T) * w * w,
                    stream, w, (const T*)a, (T*)out, iters))
}

// bytes of dynamic shared memory for one block; out: one float on the card
extern "C" int calib_smem_probe(void* stream, long long bytes, void* out) {
  if (bytes < 8 || bytes > 2147483647LL) return (int)cudaErrorInvalidValue;
  return go(smem_probe_kernel, 1, 32, (size_t)bytes, stream,
            bytes / (long long)sizeof(float), (float*)out);
}
