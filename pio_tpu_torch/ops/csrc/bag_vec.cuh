// Vector row access shared by the embedding-bag kernels (embedding_bag.cu,
// embedding_bag_bwd.cu): a lane moves VEC bytes of a row as one load or
// store of RawVec<VEC>::type, and widens each element to f32 exactly.
//
// The build hashes every header under csrc/ with each source, so an edit
// here rebuilds both libraries (pio_tpu_torch/ops/_build.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace pio_bag {

constexpr int kWarp = 32;

template <int VEC>
struct RawVec;
template <>
struct RawVec<16> { using type = uint4; };
template <>
struct RawVec<8> { using type = uint2; };
template <>
struct RawVec<4> { using type = unsigned int; };
template <>
struct RawVec<2> { using type = unsigned short; };

// r = *p where pred, else r unchanged: one predicated non-coherent load and
// no branch, so the loads a thread unrolls stay in flight together. An `if`
// around __ldg timed slower on the H100, most at one bag.
__device__ __forceinline__ void load_if(uint4& r, const void* p, bool pred) {
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %5, 0;\n\t"
      "@q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n\t}"
      : "+r"(r.x), "+r"(r.y), "+r"(r.z), "+r"(r.w)
      : "l"(p), "r"(static_cast<int>(pred)));
}
__device__ __forceinline__ void load_if(uint2& r, const void* p, bool pred) {
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\t"
      "@q ld.global.nc.v2.u32 {%0, %1}, [%2];\n\t}"
      : "+r"(r.x), "+r"(r.y)
      : "l"(p), "r"(static_cast<int>(pred)));
}
__device__ __forceinline__ void load_if(unsigned int& r, const void* p,
                                        bool pred) {
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "@q ld.global.nc.u32 %0, [%1];\n\t}"
      : "+r"(r)
      : "l"(p), "r"(static_cast<int>(pred)));
}
__device__ __forceinline__ void load_if(unsigned short& r, const void* p,
                                        bool pred) {
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t"
      "@q ld.global.nc.u16 %0, [%1];\n\t}"
      : "+h"(r)
      : "l"(p), "r"(static_cast<int>(pred)));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch's cast
}

// N consecutive elements of T from v at p (aligned to N * sizeof(T) bytes),
// as one store
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  using Raw = typename RawVec<N * sizeof(T)>::type;
  T h[N];
#pragma unroll
  for (int e = 0; e < N; ++e) h[e] = from_f32<T>(v[e]);
  Raw r;
  memcpy(&r, h, sizeof(Raw));
  *reinterpret_cast<Raw*>(p) = r;
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace pio_bag
