// Backward of the weighted embedding bag for Hopper (sm_90a). The forward
// (embedding_bag.cu) is out[b] = sum_l w[b, l] * table[ids[b, l]]; given the
// f32 gradient g [B, D] of out, this file holds its two halves:
//
//   A. bag scatter, d_table [V, D] in the table's type:
//        d_table[v, d] = sum over (b, l) with ids[b, l] = v of w[b, l] * g[b, d]
//   B. bag dot, d_w [B, L] f32:
//        d_w[b, l] = sum_d g[b, d] * table[ids[b, l], d]
//
// Replaces the backward of pio_tpu/ops/embedding.py:embedding_bag, the
// custom_vjp's _bwd (l.271-286), which is XLA there and not Pallas: d_table is
// a segment_sum over a [B*L, D] contribution tensor it writes first (1.48 GB
// at 11314 bags of 256 slots and D = 128), d_w a gather of [B, L, D] rows and
// an einsum. Neither tensor exists here.
//
// Kernel A also gives the multinomial NB's per-class feature sums
// (pio_tpu/models/naive_bayes.py:train_multinomial_nb_bags): key y*V + id,
// D = 1 and g = 1.
//
// What bounds them on the H100. Bytes, never arithmetic: 2 flops per g or
// table element read.
//  - A reads the ids and weights of the slots, each g row once for each
//    non-zero slot of its bag (from L2 mostly: g is 5.8 MB at the training
//    shape) and writes d_table once. Every row of d_table is written, also
//    rows no slot touches (they are 0): at V = 65537, D = 128 that is 33.5 MB
//    f32, more than the slots' 23 MB.
//  - B is the forward's gather with a dot in place of the sum: B*L table
//    rows (from L2: the f32 table is 33.5 MB), ids, g and d_w.
//
// Design, kept simple in this first version:
//  - No atomics, and the same bits on every call. A owns each output row:
//    one group of lanes per row of d_table walks that row's slots in the
//    order the host's plan lists them (a stable sort of the slots by id, so
//    (b, l) ascending), lanes across D, and sums in f32 registers in that
//    fixed order. Rows are written once, with 0 where no slot lands. B
//    computes each d_w element in one group: each lane sums its columns in
//    order, then an xor-shuffle butterfly joins the lanes of the group.
//  - The plan (pio_tpu_torch/ops/embedding.py: bag_plan) lists only slots
//    of non-zero weight: A reads no g row for a weight-0 slot. B must read
//    every slot, weight 0 or not: the derivative with respect to a zero
//    weight is not zero.
//  - Each lane moves EPL elements (4, 2 or 1) as one load or store of
//    EPL * sizeof(element) bytes; kUnroll slots are loaded before any is
//    used, so their row loads are in flight together.
//  - Launch geometry is chosen on the host (embedding.py: _bwd_geometry)
//    and launched as given; the entry points only check it.
//
// A row with very many slots (a common token in every document) is walked
// by one group alone: the step waits for the longest row. Splitting such
// rows across warps is left for a later version (PERF.md).
//
// Element types: f32 and bf16 tables (B widens them to f32 exactly; A rounds
// its f32 sums to nearest even, as torch's cast). ids int32 in [0, V); g
// and weights f32. All arrays contiguous. Nothing is allocated and nothing
// synchronises.

#include "bag_vec.cuh"

namespace {

using pio_bag::aligned;
using pio_bag::kWarp;
using pio_bag::load_if;
using pio_bag::RawVec;
using pio_bag::store_vec;
using pio_bag::to_f32;

// slots whose rows a thread has in flight
constexpr int kUnroll = 8;
// most threads a block; the launch bounds let ptxas give a thread the
// registers that kUnroll rows in flight take
constexpr int kMaxThreads = 256;

template <typename T, int EPL>
__global__ void __launch_bounds__(kMaxThreads)
    bag_scatter_kernel(const float* __restrict__ g,
                       const float* __restrict__ weights,
                       const int32_t* __restrict__ order,
                       const int32_t* __restrict__ offsets,
                       T* __restrict__ out, int n_rows, int L, int D,
                       int group_lanes) {
  using Raw = typename RawVec<EPL * sizeof(float)>::type;
  const int64_t row = static_cast<int64_t>(blockIdx.x) *
                          (blockDim.x / group_lanes) +
                      threadIdx.x / group_lanes;
  if (row >= n_rows) return;  // no shuffles below
  const int lane = threadIdx.x % group_lanes;
  const int begin = __ldg(offsets + row);
  const int end = __ldg(offsets + row + 1);

  for (int c = lane * EPL; c < D; c += group_lanes * EPL) {
    float acc[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
    for (int k0 = begin; k0 < end; k0 += kUnroll) {
      int32_t slot[kUnroll];
      float w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        slot[u] = k0 + u < end ? __ldg(order + k0 + u) : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        w[u] = k0 + u < end ? __ldg(weights + slot[u]) : 0.f;
      }
      Raw r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        r[u] = Raw{};
        const int64_t bag = slot[u] / L;
        load_if(r[u], g + bag * D + c, w[u] != 0.f);
      }
      // slot order: the same additions on every call
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float* v = reinterpret_cast<const float*>(&r[u]);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] += w[u] * v[e];
      }
    }
    store_vec<T, EPL>(out + row * D + c, acc);
  }
}

template <typename T, int EPL>
__global__ void __launch_bounds__(kMaxThreads)
    bag_dot_kernel(const T* __restrict__ table,
                   const int32_t* __restrict__ ids,
                   const float* __restrict__ g, float* __restrict__ out, int B,
                   int L, int D, int group_lanes) {
  using RawT = typename RawVec<EPL * sizeof(T)>::type;
  using RawG = typename RawVec<EPL * sizeof(float)>::type;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t bag =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (bag >= B) return;  // uniform over the warp
  const int groups = kWarp / group_lanes;
  const int group = lane / group_lanes;
  const int col0 = (lane % group_lanes) * EPL;
  const int32_t* bag_ids = ids + bag * L;
  const float* bag_g = g + bag * D;
  float* bag_out = out + bag * L;

  // the bound is uniform over the warp, so every lane reaches each shuffle
  for (int base = 0; base < L; base += kUnroll * groups) {
    int32_t id[kUnroll];
    bool in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int l = base + u * groups + group;
      in[u] = l < L;
      id[u] = in[u] ? __ldg(bag_ids + l) : 0;
    }
    float part[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) part[u] = 0.f;
    for (int c = col0; c < D; c += group_lanes * EPL) {
      RawG gr = RawG{};
      load_if(gr, bag_g + c, true);
      const float* gv = reinterpret_cast<const float*>(&gr);
      RawT r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        r[u] = RawT{};
        load_if(r[u], table + static_cast<int64_t>(id[u]) * D + c, in[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* v = reinterpret_cast<const T*>(&r[u]);
#pragma unroll
        for (int e = 0; e < EPL; ++e) part[u] += gv[e] * to_f32(v[e]);
      }
    }
    // the lanes of one group: a butterfly, the same sum in every lane
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      for (int off = group_lanes / 2; off > 0; off >>= 1) {
        part[u] += __shfl_xor_sync(0xffffffffu, part[u], off);
      }
    }
    if (col0 == 0) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (in[u]) bag_out[base + u * groups + group] = part[u];
      }
    }
  }
}

// The host's geometry (embedding.py: BwdGeometry), as it is launched: each
// group of `group_lanes` lanes owns one output row (A) or one slot at a
// time (B, one warp a bag).
struct Geometry {
  int epl, group_lanes, grid_x, threads;
};

bool geometry_ok(const Geometry& g, int64_t items, int64_t items_per_block) {
  return g.group_lanes >= 1 && g.group_lanes <= kWarp &&
         (g.group_lanes & (g.group_lanes - 1)) == 0 && g.threads >= kWarp &&
         g.threads % kWarp == 0 && g.threads <= kMaxThreads && g.grid_x >= 1 &&
         static_cast<int64_t>(g.grid_x) * items_per_block >= items;
}

template <typename T, int EPL>
int scatter_epl(const void* g, const void* weights, const void* order,
                const void* offsets, void* out, int n_rows, int L, int D,
                const Geometry& geo, cudaStream_t stream) {
  if (!geometry_ok(geo, n_rows, geo.threads / geo.group_lanes) ||
      D % EPL != 0 || !aligned(g, EPL * sizeof(float)) ||
      !aligned(out, EPL * sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bag_scatter_kernel<T, EPL><<<geo.grid_x, geo.threads, 0, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(weights),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(offsets),
      static_cast<T*>(out), n_rows, L, D, geo.group_lanes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int EPL>
int dot_epl(const void* table, const void* ids, const void* g, void* out,
            int B, int L, int D, const Geometry& geo, cudaStream_t stream) {
  if (!geometry_ok(geo, B, geo.threads / kWarp) || D % EPL != 0 ||
      !aligned(table, EPL * sizeof(T)) || !aligned(g, EPL * sizeof(float))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  bag_dot_kernel<T, EPL><<<geo.grid_x, geo.threads, 0, stream>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(ids),
      static_cast<const float*>(g), static_cast<float*>(out), B, L, D,
      geo.group_lanes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int scatter(const void* g, const void* weights, const void* order,
            const void* offsets, void* out, int n_rows, int L, int D,
            const Geometry& geo, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (geo.epl) {
    case 4:
      return scatter_epl<T, 4>(g, weights, order, offsets, out, n_rows, L, D,
                               geo, s);
    case 2:
      return scatter_epl<T, 2>(g, weights, order, offsets, out, n_rows, L, D,
                               geo, s);
    case 1:
      return scatter_epl<T, 1>(g, weights, order, offsets, out, n_rows, L, D,
                               geo, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dot(const void* table, const void* ids, const void* g, void* out, int B,
        int L, int D, const Geometry& geo, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (geo.epl) {
    case 4:
      return dot_epl<T, 4>(table, ids, g, out, B, L, D, geo, s);
    case 2:
      return dot_epl<T, 2>(table, ids, g, out, B, L, D, geo, s);
    case 1:
      return dot_epl<T, 1>(table, ids, g, out, B, L, D, geo, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. The four ints before the stream
// are the host's geometry: elements a lane, lanes a group, grid x and
// threads a block. Each returns cudaGetLastError() after the launch
// (0 = cudaSuccess), or cudaErrorInvalidValue without launching for a
// geometry or an alignment it cannot run.
//
// Kernel A: g f32 [B, D], weights f32 [B, L], the plan's order int32 [nnz]
// (flat slot indices b*L + l) and offsets int32 [n_rows + 1] → out
// [n_rows, D]. Requires n_rows >= 1, D >= 1 and L >= 1 where nnz > 0.
#define PIO_BAG_SCATTER_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const void* g, const void* weights, const void* order, \
                      const void* offsets, void* out, int n_rows, int L,     \
                      int D, int epl, int group_lanes, int grid_x,           \
                      int threads, void* stream) {                           \
    const Geometry geo{epl, group_lanes, grid_x, threads};                   \
    return scatter<T>(g, weights, order, offsets, out, n_rows, L, D, geo,    \
                      stream);                                               \
  }

// Kernel B: table [V, D], ids int32 [B, L], g f32 [B, D] → out f32 [B, L].
// Requires B >= 1, L >= 1 and D >= 1.
#define PIO_BAG_DOT_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* table, const void* ids, const void* g,     \
                      void* out, int B, int L, int D, int epl,               \
                      int group_lanes, int grid_x, int threads,              \
                      void* stream) {                                        \
    const Geometry geo{epl, group_lanes, grid_x, threads};                   \
    return dot<T>(table, ids, g, out, B, L, D, geo, stream);                 \
  }

PIO_BAG_SCATTER_ENTRY(pio_bag_scatter_f32, float)
PIO_BAG_SCATTER_ENTRY(pio_bag_scatter_bf16, __nv_bfloat16)
PIO_BAG_DOT_ENTRY(pio_bag_dot_f32, float)
PIO_BAG_DOT_ENTRY(pio_bag_dot_bf16, __nv_bfloat16)
