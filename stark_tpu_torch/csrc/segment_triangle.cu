// Kernel H: "does any frozen edge-triangle candidate intersect?"
//
// Replaces stark_tpu/models/interactions/contact_engine.py `_isect_exact`
// (:1782-1800), which maps stark_tpu/collision/narrow_phase.py:398
// `segment_triangle_intersects` (Moller-Trumbore, inclusive) over the frozen
// ET mid list and reduces with any(), ORed with the list's overflow flag
// (an overflowed candidate list counts as a hit). One thread per row; each
// block ORs its rows with __syncthreads_or and one thread of a hitting block
// raises the single device flag. The flag starts as a device-to-device copy
// of the overflow flag, so the verdict never visits the host here; the
// solver reads it once per line-search trial.
//
// Bound: bytes. Per row: the 2 row indices, act, 5 gathered 3-vectors (with
// their table entries); one byte written.
#include "narrow.cuh"

template <typename T>
__global__ void segment_triangle_any_kernel(
    const T* __restrict__ V, const int* __restrict__ edges,
    const int* __restrict__ tris, const int* __restrict__ e,
    const int* __restrict__ t, int R, const uint8_t* __restrict__ act, T ptol,
    uint8_t* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  bool hit = false;
  if (r < R && act[r]) {
    const int* ed = edges + 2LL * e[r];
    const int* tr = tris + 3LL * t[r];
    hit = segment_triangle_intersects(ld3(V + 3LL * ed[0]), ld3(V + 3LL * ed[1]),
                                      ld3(V + 3LL * tr[0]), ld3(V + 3LL * tr[1]),
                                      ld3(V + 3LL * tr[2]), ptol);
  }
  if (__syncthreads_or(hit) && threadIdx.x == 0) *out = 1;
}

template <typename T>
static int launch_any(const T* V, const int* edges, const int* tris,
                      const int* e, const int* t, int R, const uint8_t* act,
                      double ptol, const uint8_t* overflow, uint8_t* out,
                      cudaStream_t stream) {
  cudaMemcpyAsync(out, overflow, 1, cudaMemcpyDeviceToDevice, stream);
  if (R == 0) return stk_launch_status();
  const int threads = 256;
  segment_triangle_any_kernel<T><<<stk_blocks(R, threads), threads, 0, stream>>>(
      V, edges, tris, e, t, R, act, (T)ptol, out);
  return stk_launch_status();
}

STK_API int stk_segment_triangle_any_f32(const float* V, const int* edges,
                                         const int* tris, const int* e,
                                         const int* t, int R,
                                         const uint8_t* act, double ptol,
                                         const uint8_t* overflow, uint8_t* out,
                                         cudaStream_t stream) {
  return launch_any<float>(V, edges, tris, e, t, R, act, ptol, overflow, out,
                           stream);
}

STK_API int stk_segment_triangle_any_f64(const double* V, const int* edges,
                                         const int* tris, const int* e,
                                         const int* t, int R,
                                         const uint8_t* act, double ptol,
                                         const uint8_t* overflow, uint8_t* out,
                                         cudaStream_t stream) {
  return launch_any<double>(V, edges, tris, e, t, R, act, ptol, overflow, out,
                            stream);
}
