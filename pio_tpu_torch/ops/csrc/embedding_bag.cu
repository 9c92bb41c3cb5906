// Weighted embedding bag for Hopper (sm_90a):
//
//     out[b, d] = sum_l weights[b, l] * table[ids[b, l], d]      (f32 [B, D])
//
// Replaces the Pallas TPU kernel pio_tpu/ops/embedding.py:_embedding_bag_pallas
// (kernel body _make_bag_kernel). That kernel walks 8-bag tiles in order on
// one TPU core and streams single table rows HBM->VMEM through a 4-deep DMA
// ring, so the gathered [B, L, D] tensor never exists. Here it does not
// either: rows go from L2 or HBM straight into f32 registers.
//
// What bounds it on the H100 (timed by chip_smoke.py). Memory, never
// arithmetic: 2 flops per row element read. At the served shapes
// (V = 65537, D = 128; B = 1024 bags of L = 256 a batch chunk, B = 1 a
// query):
//  - batch: the 33.5 MB f32 table fits in the 50 MB L2, so each distinct
//    row leaves HBM about once, and the limit is the rate at which L2 hands
//    the SMs the B*L*D*sizeof(T) gathered row bytes (134 MB f32, 67 MB
//    bf16). A gather of random rows has no reuse inside a block, so no
//    staging in shared memory can cut those bytes;
//  - query: the 256 rows (128 KB) take a small part of the time. The rest
//    is the launch, two dependent round trips (ids and weights, then rows)
//    and the block's reduction; a launch of the same bag with every weight
//    0 takes nearly as long.
//
// Design:
//  - L split across warps. A block owns `bags_per_block` bags and one
//    `col_slice`-wide slice of D (grid y walks the slices). Each bag has
//    `warps_per_bag` warps; a warp is cut into groups of `group_lanes`
//    lanes, and each group reads one row slice per step. Slot l of a bag
//    goes to group l mod (groups of the bag): the padding at the end of a
//    bag is spread over all groups, so none of them idles while another
//    walks the real slots. A thread issues kUnroll predicated row loads
//    (no branch) before it uses any, so they are in flight together.
//  - 16-byte row loads. Each lane reads vec_bytes of a row (16: a float4,
//    or 8 bf16 values); a 128-wide f32 row is one warp load, a 128-wide
//    bf16 row a half-warp, two rows per instruction. Where the row bytes or
//    the table pointer are not 16-byte aligned, the host picks the same
//    kernel with 8-, 4- or 2-byte lanes (vec_bytes).
//  - Fixed summation order, no atomics: each thread sums its slots in
//    increasing l in f32 registers, the groups of a warp are joined by an
//    xor-shuffle butterfly, and the warps of a bag through shared memory,
//    summed warp 0, 1, ... by one thread per column. Every output element is
//    stored once; two calls on the same inputs give the same bits.
//  - Weight-0 slots are skipped: the row is not read. The packer pads bags
//    with id 0 / weight 0, and served TF-IDF bags are often shorter than L.
//    The predicate is uniform over a group (one slot per group). The result
//    differs from the plain version's 0*row only where a skipped row holds
//    inf or NaN (0*inf is NaN there, nothing here).
//
// Launch geometry is chosen on the host alone (pio_tpu_torch/ops/embedding.py:
// _plan) and passed in whole: grid, block size and shared memory are
// launched as given. The entry points only check it and return
// cudaErrorInvalidValue for a geometry the kernel cannot run.
//
// Element types: f32 and bf16 tables (converted to f32 exactly before the
// multiply). ids are int32 and must lie in [0, V): the callers check that on
// the host. weights are f32. All arrays are contiguous. The kernel allocates
// nothing and does not synchronise.

#include "bag_vec.cuh"

namespace {

using pio_bag::kWarp;
using pio_bag::aligned;
using pio_bag::load_if;
using pio_bag::RawVec;
using pio_bag::to_f32;

constexpr int kMaxThreads = 1024;
constexpr int kMaxSharedBytes = 48 * 1024;  // static-launch limit, no opt-in
// independent row loads a thread has in flight
constexpr int kUnroll = 8;

// N consecutive floats at p (aligned to 4*N bytes, or 16 for N = 8)
template <int N>
__device__ __forceinline__ void store_f32(float* p, const float* v) {
  if constexpr (N == 1) {
    *p = v[0];
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  }
}

// The minimum of one block per SM lets ptxas use up to 64 registers a thread;
// without it, it held the f32 16-byte kernel to 32 and issued its row loads
// one after another.
template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads, 1)
    embedding_bag_kernel(const T* __restrict__ table,
                         const int32_t* __restrict__ ids,
                         const float* __restrict__ weights,
                         float* __restrict__ out, int B, int L, int D,
                         int warps_per_bag, int bags_per_block,
                         int group_lanes) {
  using Raw = typename RawVec<VEC>::type;
  constexpr int kEpl = VEC / sizeof(T);  // elements per lane
  // [bags_per_block][warps_per_bag][col_slice] partial rows
  extern __shared__ float partial[];

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int bag_local = warp / warps_per_bag;
  const int warp_in_bag = warp % warps_per_bag;
  const int64_t bag = static_cast<int64_t>(blockIdx.x) * bags_per_block +
                      bag_local;
  const int groups_per_warp = kWarp / group_lanes;
  const int groups_per_bag = warps_per_bag * groups_per_warp;
  const int group = warp_in_bag * groups_per_warp + lane / group_lanes;
  const int col_slice = group_lanes * kEpl;
  const int col_in_slice = (lane % group_lanes) * kEpl;
  // D % kEpl == 0: a lane's kEpl columns are all in range or all out
  const int col = blockIdx.y * col_slice + col_in_slice;
  const bool live = bag < B && col < D;

  float acc[kEpl];
#pragma unroll
  for (int e = 0; e < kEpl; ++e) acc[e] = 0.f;

  if (bag < B) {  // uniform over the warp
    const int32_t* bag_ids = ids + bag * L;
    const float* bag_w = weights + bag * L;
    const int step = kUnroll * groups_per_bag;
    for (int l0 = group; l0 < L; l0 += step) {
      int32_t id[kUnroll];
      float w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int l = l0 + u * groups_per_bag;
        const bool in = l < L;
        id[u] = in ? __ldg(bag_ids + l) : 0;
        w[u] = in ? __ldg(bag_w + l) : 0.f;
      }
      Raw r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        r[u] = Raw{};
        load_if(r[u], table + static_cast<int64_t>(id[u]) * D + col,
                live && w[u] != 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* v = reinterpret_cast<const T*>(&r[u]);
#pragma unroll
        for (int e = 0; e < kEpl; ++e) acc[e] += w[u] * to_f32(v[e]);
      }
    }
  }

  // the groups of one warp: a butterfly, the same additions on every run
  for (int off = group_lanes; off < kWarp; off <<= 1) {
#pragma unroll
    for (int e = 0; e < kEpl; ++e) {
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    }
  }
  if (warps_per_bag == 1) {  // uniform over the block
    if (live && lane < group_lanes) store_f32<kEpl>(out + bag * D + col, acc);
    return;
  }
  // the warps of one bag: through shared memory, summed in warp order
  if (lane < group_lanes) {
    store_f32<kEpl>(
        partial + (bag_local * warps_per_bag + warp_in_bag) * col_slice +
            col_in_slice,
        acc);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bags_per_block * col_slice; i += blockDim.x) {
    const int bl = i / col_slice;
    const int c = i % col_slice;
    const int64_t b = static_cast<int64_t>(blockIdx.x) * bags_per_block + bl;
    const int d = blockIdx.y * col_slice + c;
    if (b >= B || d >= D) continue;
    const float* p = partial + bl * warps_per_bag * col_slice + c;
    float s = p[0];
    for (int k = 1; k < warps_per_bag; ++k) s += p[k * col_slice];
    out[b * D + d] = s;
  }
}

// The host's plan (pio_tpu_torch/ops/embedding.py: Plan), as it is launched.
struct Geometry {
  int warps_per_bag, bags_per_block, group_lanes;
  int grid_x, grid_y, threads, smem_bytes;
};

// Whether the kernel can run `g` on these arguments and covers every bag
// and column once: the plan is checked here, never recomputed.
template <typename T, int VEC>
bool runs(const Geometry& g, const void* table, const void* out, int B,
          int D) {
  constexpr int kEpl = VEC / sizeof(T);
  const int64_t col_slice = static_cast<int64_t>(g.group_lanes) * kEpl;
  const int64_t warps = static_cast<int64_t>(g.warps_per_bag) * g.bags_per_block;
  const int64_t smem_needed = g.warps_per_bag > 1 ? warps * col_slice * 4 : 0;
  return g.group_lanes >= 1 && g.group_lanes <= kWarp &&
         (g.group_lanes & (g.group_lanes - 1)) == 0 && g.warps_per_bag >= 1 &&
         g.bags_per_block >= 1 && g.threads == warps * kWarp &&
         g.threads <= kMaxThreads && g.smem_bytes >= smem_needed &&
         g.smem_bytes <= kMaxSharedBytes && g.grid_x >= 1 && g.grid_y >= 1 &&
         g.grid_y <= 65535 &&
         static_cast<int64_t>(g.grid_x) * g.bags_per_block >= B &&
         static_cast<int64_t>(g.grid_y) * col_slice >= D && D % kEpl == 0 &&
         aligned(table, VEC) && aligned(out, kEpl * sizeof(float));
}

template <typename T, int VEC>
int launch_vec(const void* table, const void* ids, const void* weights,
               void* out, int B, int L, int D, const Geometry& g,
               cudaStream_t stream) {
  if (!runs<T, VEC>(g, table, out, B, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  embedding_bag_kernel<T, VEC>
      <<<dim3(g.grid_x, g.grid_y), g.threads, g.smem_bytes, stream>>>(
          static_cast<const T*>(table), static_cast<const int32_t*>(ids),
          static_cast<const float*>(weights), static_cast<float*>(out), B, L,
          D, g.warps_per_bag, g.bags_per_block, g.group_lanes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* table, const void* ids, const void* weights, void* out,
           int B, int L, int D, int vec_bytes, const Geometry& g,
           void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16:
      return launch_vec<T, 16>(table, ids, weights, out, B, L, D, g, s);
    case 8:
      return launch_vec<T, 8>(table, ids, weights, out, B, L, D, g, s);
    case 4:
      return launch_vec<T, 4>(table, ids, weights, out, B, L, D, g, s);
    case 2:
      if constexpr (sizeof(T) == 2) {
        return launch_vec<T, 2>(table, ids, weights, out, B, L, D, g, s);
      }
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface, loaded with ctypes. Requires B >= 1 and D >= 1; the
// ints after D are the host's plan: lane width, warps a bag, bags a block,
// lanes a row group, grid x and y, threads a block and shared-memory bytes.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue without launching for a plan it cannot run.
#define PIO_EMBEDDING_BAG_ENTRY(NAME, T)                                      \
  extern "C" int NAME(const void* table, const void* ids, const void* weights, \
                      void* out, int B, int L, int D, int vec_bytes,           \
                      int warps_per_bag, int bags_per_block, int group_lanes,  \
                      int grid_x, int grid_y, int threads, int smem_bytes,     \
                      void* stream) {                                          \
    const Geometry g{warps_per_bag, bags_per_block, group_lanes, grid_x,       \
                     grid_y,        threads,        smem_bytes};               \
    return launch<T>(table, ids, weights, out, B, L, D, vec_bytes, g, stream); \
  }

PIO_EMBEDDING_BAG_ENTRY(pio_embedding_bag_f32, float)
PIO_EMBEDDING_BAG_ENTRY(pio_embedding_bag_bf16, __nv_bfloat16)
