// Monolithic staged IPM for Hopper (sm_90a).
//
// Replaces the TPU kernel scpp_tpu/solver/ipm_mono.py:_mono_kernel (body
// _solve_block): the whole NT-Mehrotra predictor-corrector SOCP solve of
// a batch of gm == 0 staged programs (cold/warm init, residuals and
// score, NT scaling, Gram/KKT assembly, signed block factorization and
// solves, predictor and corrector, cone step lengths, masked update,
// best-iterate tracking, early exit, final rescoring) in one launch. Its
// plain version is `_solve_block` in scpp_tpu_torch/solver/ipm_mono.py.
//
// Memory plan: one thread block per scenario, looping over the IPM
// iterations inside the block, so nothing but the inputs and outputs
// crosses the launch. The KKT factor of one flagship scenario (K=30 stages
// of 48 x 48 blocks, ~276 KB in fp32) is larger than a block's 227 KB of
// shared memory, so the factor (L_k^{-1} and the coupling P_k of every
// stage) and the iterate vectors live in a global workspace that the
// wrapper allocates; shared memory holds the stage tiles being worked on
// (W^{-1} G_k^T, the block D_k and its factor, P_{k-1}, the Gram blocks).
// Cyclic reduction existed for the TPU's vector width: here the stages are
// factored and solved by a sequential recursion, which gives the same
// solution up to rounding.
//
// What bounds it: per IPM iteration and scenario, the factor does about
// K * (3 w^2 (mc + me) + w^2 Wp + Wp^3 / 3 + Wp^2 w / 2) ~ 10 M fp32 FMAs
// at the flagship shapes (the count chip_smoke.py:mono_work uses; plain
// FMA loops, no TF32, no tensor cores), while the bytes it must move are
// the ~0.5 MB of inputs once. So it is bound by operations, and in this
// first version by the latency of the sequential column recursion (one
// __syncthreads per Cholesky column and per stage of each sweep), not by
// the card's FMA rate. The early exit is per scenario: a converged
// scenario frees its SM.
//
// Iteration count: diag[:, 1] counts the iterations of each scenario on
// its own (the JAX kernel counts per sub-batch of MONO_BSUB scenarios).
//
// `part` isolates a piece of the solve, as the reference's hook does:
// -1 the whole solve, -2 the initialization alone (the starting point and
// a zero diag), N >= 0 exactly N iterations whatever `iters` says. A
// scenario that is done stops early in every case: its iterate is frozen
// and its best-iterate tracking would keep the same point, so the outputs
// are those of the reference, which keeps calling the body.
//
// Interface: a plain C function, loaded with ctypes; it launches on the
// given stream, allocates nothing, and returns the cudaError_t of the
// launch (or cudaErrorInvalidValue for arguments it does not take).

#include <cuda_runtime.h>

#include "mono_ipm_body.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
mono_ipm_kernel(mono::Dims dims, const T* AT, const T* GT, const T* beq,
                const T* h, const T* c, const T* deq, const T* dc,
                const T* Est, const T* scal, const T* wx, const T* wy,
                const T* wz, T* ox, T* oy, T* os, T* oz, T* odiag, T* work) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long b = blockIdx.x;
  const int K = dims.K, w = dims.w, me = dims.me, mc = dims.mc;
  const long long nw = (long long)K * w, ne = (long long)K * me,
                  nc = (long long)K * mc;
  mono::Solver<T> solver(
      dims, reinterpret_cast<T*>(smem_raw),
      work + b * mono::workspace_elems(K, w, me, mc),
      AT + b * 2 * w * ne, GT + b * 2 * w * nc, beq + b * ne, h + b * nc,
      c + b * nw, deq + b * ne, dc + b * nc, Est + b * nw);
  solver.run(scal + b * 4, wx + b * nw, wy + b * ne, wz + b * nc,
             ox + b * nw, oy + b * ne, os + b * nc, oz + b * nc,
             odiag + b * 4);
}

template <typename T>
int launch(const mono::Dims& dims, int B, void* stream, void** in,
           void** out, void* work) {
  const size_t smem = sizeof(T) * mono::smem_elems(dims.w, dims.me, dims.mc,
                                                   kThreads);
  cudaError_t err = cudaFuncSetAttribute(
      mono_ipm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  mono_ipm_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      dims, (const T*)in[0], (const T*)in[1], (const T*)in[2],
      (const T*)in[3], (const T*)in[4], (const T*)in[5], (const T*)in[6],
      (const T*)in[7], (const T*)in[8], (const T*)in[9], (const T*)in[10],
      (const T*)in[11], (T*)out[0], (T*)out[1], (T*)out[2], (T*)out[3],
      (T*)out[4], (T*)work);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long mono_ipm_workspace_elems(int K, int w, int me, int mc) {
  return mono::workspace_elems(K, w, me, mc);
}

// in: AT, GT, b_eq, h, c, d_eq, d_c, E_st, scal, warm_x, warm_y, warm_z
// out: x, y, s, z, diag (see _solve_block for the shapes); part: see above
extern "C" int mono_ipm_launch(int elem_bytes, void* stream, int B, int K,
                               int w, int me, int l, int S,
                               const int* soc_sizes, int iters,
                               int refine_steps, int track_best, int part,
                               double eps_reg, double rho, double eps_feas,
                               double step_frac, double warm_kappa,
                               void** in, void** out, void* work) {
  if (B < 1 || K < 2 || w < 1 || me < 1 || S < 0 || S > mono::kMaxSoc ||
      part < -2)
    return (int)cudaErrorInvalidValue;
  mono::Dims dims;
  dims.K = K; dims.w = w; dims.me = me; dims.l = l; dims.S = S;
  int off = l;
  for (int i = 0; i < S; ++i) {
    dims.soc_off[i] = off;
    dims.soc_q[i] = soc_sizes[i];
    off += soc_sizes[i];
  }
  dims.mc = off;
  dims.Wp = w + me;
  dims.iters = iters;
  dims.refine_steps = refine_steps;
  dims.track_best = track_best;
  dims.part = part;
  dims.eps_reg = eps_reg;
  dims.rho = rho;
  dims.eps_feas = eps_feas;
  dims.step_frac = step_frac;
  dims.warm_kappa = warm_kappa;
  if (elem_bytes == 4) return launch<float>(dims, B, stream, in, out, work);
  if (elem_bytes == 8) return launch<double>(dims, B, stream, in, out, work);
  return (int)cudaErrorInvalidValue;
}
