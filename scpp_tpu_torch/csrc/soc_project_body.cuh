// Device body of the second-order-cone projection: each work item
// projects one SOC block (t, z_1..z_{q-1}) of one scenario's cone vector
// onto ||z|| <= t, in place, as the plain version
// `soc_project_blocks_reference` in scpp_tpu_torch/ops/soc_project.py
// does for a batch. See soc_project.cu for the kernel entry and what
// bounds it on the card.
//
// Layouts: w (B rows of stride ld), the blocks of a row at w + head[c],
// c < n_cones, each of size[c] values; every scenario has the same
// blocks. Work item i is scenario i / n_cones, cone i % n_cones. The sum
// of squares runs over the block in index order, one work item per cone
// (no atomics), so the result does not depend on the thread count.
#pragma once

namespace soc {

// The three cases of the projection, as the reference's selects:
// inside (||z|| <= t): unchanged; below (||z|| <= -t): zero;
// otherwise a = (t + ||z||) / 2 and (a, z a / max(||z||, 1e-30)).
// NaN in the block fails both tests and gives NaN, as in the reference.
template <typename T>
__device__ __forceinline__ void project_block(T* blk, int q) {
  const T t = blk[0];
  T ss = T(0);
  for (int j = 1; j < q; ++j) ss += blk[j] * blk[j];
  const T zn = sqrt(ss);
  if (zn <= t) return;                      // inside: x * 1 == x
  const bool below = zn <= -t;
  const T a = T(0.5) * (t + zn);
  const T safe = zn > T(1e-30) ? zn : T(1e-30);
  const T t_new = below ? T(0) : a;
  const T scale = below ? T(0) : a / safe;
  blk[0] = t_new;
  for (int j = 1; j < q; ++j) blk[j] = blk[j] * scale;
}

template <typename T>
__device__ __forceinline__ void project_item(long long i, int n_cones,
                                             long long ld, const int* head,
                                             const int* size, T* w) {
  const long long s = i / n_cones;
  const int c = (int)(i % n_cones);
  project_block<T>(w + s * ld + head[c], size[c]);
}

}  // namespace soc
