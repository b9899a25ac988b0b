// Host shim for the kernel bodies (*_body.cuh): lets g++ compile the device
// code of a body as plain C++, so that the CPU tests check its arithmetic.
// `__device__` and friends are empty, each CUDA thread of a block is a
// std::thread with its own `threadIdx`, and `__syncthreads` is a barrier
// over the threads of the block being run. A harness includes this with
// `-include host_shim.h`, defines `threadIdx`, `blockDim` and `g_barrier`
// once, and runs the blocks one after another.
#pragma once
#include <barrier>
#include <cmath>
#include <math.h>
#define __device__
#define __host__
#define __forceinline__ inline
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
extern thread_local Dim3 threadIdx;
extern Dim3 blockDim;
extern std::barrier<>* g_barrier;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
