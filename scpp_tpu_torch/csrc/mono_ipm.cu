// Monolithic staged IPM for Hopper (sm_90a).
//
// Replaces the TPU kernel scpp_tpu/solver/ipm_mono.py:_mono_kernel (body
// _solve_block): the whole NT-Mehrotra predictor-corrector SOCP solve of
// a batch of gm == 0 staged programs (cold/warm init, residuals and
// score, NT scaling, Gram/KKT assembly, signed block factorization and
// solves, predictor and corrector, cone step lengths, masked update,
// best-iterate tracking, early exit, final rescoring) in one launch. Its
// plain version is `_solve_block` in scpp_tpu_torch/solver/ipm_mono.py,
// which factors and solves in the same cyclic-reduction order.
//
// Plan: one thread block of 512 threads (16 warps) per scenario, looping
// over the IPM iterations inside the block, so nothing but the inputs and
// outputs crosses the launch. Per iteration the KKT system is assembled
// for all K stages at once (W^{-1} G_k^T and the Gram blocks from shared
// tiles, stage k+1's GT, AT and scaling copied in by cp.async while stage
// k's products run), then factored by cyclic reduction in the
// reference's order (scpp_tpu/solver/mono_blocks.py:mono_cr_factor): K=30
// blocks reduce 30 -> 15 -> 8 -> 4 -> 2 -> 1, 29 odd-block factors and a
// root in 6 chained steps. Each 48 x 48 block factor (signed Cholesky in
// 8-column panels with the 1e-30 pivot floor, then L^{-1}) runs in one
// warp with __syncwarp() and shuffles alone (in registers for a float
// 48 x 48 block, else in the warp's shared tile), 15 at once in float and
// 7 in double (a 48 x 48 double tile is 20 KB; kFactorBytes); R = L^{-1}
// O_left, Q = L^{-1} O_rt^T and the Schur updates R'SR, Q'SQ, Q'SR are
// 4 x 4 register-tiled products over all threads. The couplings' last me
// rows are zero at every level, so R sums over w terms, Q has w nonzero
// columns and only the first w rows of a coupling are stored. The KKT
// solves are kernel 4's cyclic-reduction solve (cr_solve_body.cuh) on the
// same (K-1, 3, Wp, Wp) + root layout as cr_fused.cr_pack, the factor
// streamed by TMA bulk copies through a ring of slots in the shared
// region (4 float slots, 1 double at the flagship shapes; a region grown
// to 227 KB for 7 slots sped the solve and slowed the other phases by
// more, as the L1 cache shrinks with it). The factor,
// the level's blocks and the iterate vectors live in a global workspace
// (1.91 MB a scenario in float: the card's 50 MB L2 holds 26
// scenarios); shared memory holds the stage tiles, the factor tiles or
// the solve's vectors in turn (160 KB in float, 151 KB in double).
//
// What bounds it: the least work for the same function, the sequential
// stage recursion, is ~11.2 M FMAs per iteration and scenario at the
// flagship shapes (chip_smoke.py:mono_work; 0.2349 ms for the B=64 cold
// batch at the fp32 rate), and the bytes it must move are the ~0.5 MB of
// inputs once, so the bound is operations. Cyclic reduction does ~17.5 M
// FMAs per iteration (mono_work(cyclic=True)) and moves per iteration
// about 2 MB of factor and level blocks per scenario through L2 (written
// once, read by the Schur products and by each of the two solves) plus
// seven passes over the 0.5 MB of AT and GT. It runs far from both
// rates: every phase is a chain of dependent shared- or global-memory
// reads inside one block, and the per-phase clock counters (Phase,
// diag/mono_parts.py) say which chain costs what (PERF.md, section 5).
// The early exit is per scenario: a converged scenario frees its SM.
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

constexpr int kThreads = 512;
constexpr size_t kMaxSmem = 232448;   // 227 KB, a Hopper block's most

template <typename T>
__global__ void __launch_bounds__(kThreads)
mono_ipm_kernel(mono::Dims dims, const T* AT, const T* GT, const T* beq,
                const T* h, const T* c, const T* deq, const T* dc,
                const T* Est, const T* scal, const T* wx, const T* wy,
                const T* wz, T* ox, T* oy, T* os, T* oz, T* odiag, T* work,
                long long* prof) {
  const long long b = blockIdx.x;
  const int K = dims.K, w = dims.w, me = dims.me, mc = dims.mc;
  const long long nw = (long long)K * w, ne = (long long)K * me,
                  nc = (long long)K * mc;
  mono::Solver<T> solver(
      dims, work + b * mono::workspace_elems(K, w, me, mc),
      AT + b * 2 * w * ne, GT + b * 2 * w * nc, beq + b * ne, h + b * nc,
      c + b * nw, deq + b * ne, dc + b * nc, Est + b * nw);
  solver.run(scal + b * 4, wx + b * nw, wy + b * ne, wz + b * nc,
             ox + b * nw, oy + b * ne, os + b * nc, oz + b * nc,
             odiag + b * 4, prof ? prof + b * mono::kProfSlots : nullptr);
}

template <typename T>
int launch(mono::Dims dims, int B, void* stream, void** in, void** out,
           void* work, long long* prof) {
  dims.nfac = mono::factor_tiles(dims.w, dims.me, kThreads, sizeof(T));
  const size_t smem = sizeof(T) * mono::smem_elems(dims.K, dims.w, dims.me,
                                                   dims.mc, kThreads,
                                                   dims.nfac, sizeof(T));
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  // the KKT solves' ring needs a slot in the region before the reductions
  if (cr::ring_slots(dims.K, dims.Wp, smem - kThreads * sizeof(T),
                     sizeof(T)) < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mono_ipm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  mono_ipm_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      dims, (const T*)in[0], (const T*)in[1], (const T*)in[2],
      (const T*)in[3], (const T*)in[4], (const T*)in[5], (const T*)in[6],
      (const T*)in[7], (const T*)in[8], (const T*)in[9], (const T*)in[10],
      (const T*)in[11], (T*)out[0], (T*)out[1], (T*)out[2], (T*)out[3],
      (T*)out[4], (T*)work, prof);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long mono_ipm_workspace_elems(int K, int w, int me, int mc) {
  return mono::workspace_elems(K, w, me, mc);
}

extern "C" int mono_ipm_prof_slots() { return mono::kProfSlots; }

// in: AT, GT, b_eq, h, c, d_eq, d_c, E_st, scal, warm_x, warm_y, warm_z
// out: x, y, s, z, diag (see _solve_block for the shapes); part: see above;
// prof: null, or (B, kProfSlots) int64 phase counters (mono_ipm_body.cuh)
extern "C" int mono_ipm_launch(int elem_bytes, void* stream, int B, int K,
                               int w, int me, int l, int S,
                               const int* soc_sizes, int iters,
                               int refine_steps, int track_best, int part,
                               double eps_reg, double rho, double eps_feas,
                               double step_frac, double warm_kappa,
                               void** in, void** out, void* work,
                               long long* prof) {
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
  if (elem_bytes == 4)
    return launch<float>(dims, B, stream, in, out, work, prof);
  if (elem_bytes == 8)
    return launch<double>(dims, B, stream, in, out, work, prof);
  return (int)cudaErrorInvalidValue;
}
