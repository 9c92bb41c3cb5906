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
// table element read. The least bytes are each input once and each output
// once (62.5 MB for A at V = 65537, D = 128, 11314 x 256 slots), but what a
// kernel moves through L2 is what sets its time:
//  - A, one row of d_table a lane group (the first version): every g row was
//    read again for each non-zero slot of its bag, 512 B a slot at D = 128,
//    about 1.2-1.4 GB through L2 for a g of 5.8 MB, plus a scattered 32-byte
//    sector for each slot's weight. That is 20x the bound's bytes, at about
//    7 TB/s from L2: the 10x gap to the bound was these bytes.
//  - B is the forward's gather with a dot in place of the sum: B*L table
//    rows (from L2: the f32 table is 33.5 MB), ids, g and d_w.
//
// Kernel A's design: g staged in shared memory and reused by every row.
//  - A block owns DT columns of d_table (grid y walks the D / DT column
//    slices) and a share of the rows. It stages g[:, cols] of all B bags in
//    shared memory once, with cp.async (181 KB at B = 11314, DT = 4), so
//    that no g row is read from L2 again for a slot, and no barrier follows.
//    DT is the widest that fits: every slice reads the slot records again.
//  - The plan (pio_tpu_torch/ops/embedding.py: bag_plan) sorts the rows by
//    their count of non-zero slots, most first, and lays their slots out as
//    sliced ELLPACK: 32 rows of about one length a slice, slot j of the
//    slice's row i in cell 32 j + i. A warp walks a slice, a lane a row,
//    start to end, summing in f32 registers, so one slot of 32 rows is one
//    256-byte load; 8 cells are loaded before any is used. Slices go to
//    warps by a schedule the host computes once a plan (longest first, each
//    to the warp with the least work so far): rows of hundreds of slots (a
//    token in most documents) get a warp each, and the warps finish
//    together.
//  - A cell's record (bag, weight; 8 bytes) is gathered once a launch
//    (slot_records_kernel), not once a slot and column slice; a weight-0
//    slot is in no cell and reads nothing.
//  - No atomics, and the same bits on every call: each output element is
//    summed by one thread in f32, in the plan's (b, l) order, the order of
//    the first version (the same bits as it, checked on the H100). Rows
//    are written once, with 0 where no slot lands.
//  - What bounds it now: through L2 it moves the records once a slice,
//    8 * nnz * D / DT (0.7 GB at the training shape), g once a block and
//    d_table once, 0.9 GB in all against the first version's 1.35; but the
//    sums read nnz * D * 4 bytes of g from shared memory at random bags,
//    and the 16-byte reads of a quarter warp land in one of 8 bank groups
//    each, about 2.6 times the ideal wavefronts. On the H100 that costs
//    about as much time as the first version's L2 reads (PERF.md).
//  - Where g's slice of all bags does not fit even at the narrowest DT,
//    the host cuts the bags into chunks that do, one launch a chunk; a
//    row's slots of a chunk run from the plan's pass starts, and its sums
//    go to f32 scratch between launches, so the order is the same.
//
// Kernel B's design: the slots' row loads back to back, and one shuffle a
// slot. Its work is a table row a slot, every slot read, weight 0 or not:
// the derivative with respect to a zero weight is not zero.
//  - The first version (one warp a bag, 8 rows in flight) spent 30% of its
//    time (40% in bf16) on a 5-step butterfly a slot, whose sum every lane
//    got and one stored, and waited each round for its 8 ids before it
//    could load their rows. It took as long in bf16 as in f32: per-slot
//    work, not bytes, bound it (PERF.md).
//  - Now a warp walks `span` slots of a bag, 32 ids at a time, the next 32
//    loaded while the rows of these are read. A round of 8 slots a lane
//    group has all 8 rows in flight; a transpose-reduce joins the lanes in
//    9 shuffles for the 8 slots, and each sum is stored once.
//  - g's row is loaded once a warp and held in registers where one pass
//    covers it. bf16 rows load 16 bytes a lane, as f32 rows do.
//  - The launch bounds hold a thread to 64 registers (a few spill to L1):
//    32 warps an SM, 256 rows in flight. Fewer warps with more registers
//    timed slower on the H100. Both types now move about 7.7 TB/s through
//    L2 at uniform ids, and more at the main path's (repeated rows hit L1):
//    what bounds it is the L2's rate for random rows, which no sum order
//    changes.
//
// Launch geometry is chosen on the host (embedding.py: _scatter_geometry for
// A, _dot_geometry for B) and launched as given; the entry points only
// check it.
//
// Element types: f32 and bf16 tables (B widens them to f32 exactly; A rounds
// its f32 sums to nearest even, as torch's cast). ids int32 in [0, V); g
// and weights f32. All arrays contiguous. Nothing is allocated and nothing
// synchronises.

#include <climits>

#include "bag_vec.cuh"

namespace {

using pio_bag::aligned;
using pio_bag::kWarp;
using pio_bag::load_if;
using pio_bag::RawVec;
using pio_bag::store_vec;
using pio_bag::to_f32;

// ------------------------------------------------------- A. bag scatter
// most threads a block of the bag scatter; the launch bounds hold a thread
// to 64 registers, so that one block of 1024 fills an SM
constexpr int kScatterThreads = 1024;
// slots whose records a thread of kernel A has in flight
constexpr int kUnroll = 8;

// floats between two bags' columns in the g buffer: DT, padded by 16 bytes
// above 4 so that the 16-byte reads of a quarter warp (random bags) spread
// over the banks (embedding.py: _smem_stride)
__host__ __device__ constexpr int smem_stride(int dt) {
  return dt > 4 ? dt + 4 : dt;
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  }
}

// acc[e] += w * v[e] for the DT columns of one staged bag
template <int DT>
__device__ __forceinline__ void add_row(float* acc, float w, const float* v) {
  if constexpr (DT >= 4) {
#pragma unroll
    for (int q = 0; q < DT; q += 4) {
      const float4 x = *reinterpret_cast<const float4*>(v + q);
      acc[q] += w * x.x;
      acc[q + 1] += w * x.y;
      acc[q + 2] += w * x.z;
      acc[q + 3] += w * x.w;
    }
  } else if constexpr (DT == 2) {
    const float2 x = *reinterpret_cast<const float2*>(v);
    acc[0] += w * x.x;
    acc[1] += w * x.y;
  } else {
    acc[0] += w * v[0];
  }
}

// rec[q] = (src / L, bits of weights[src]) for each cell q of the plan's
// sliced layout, src = cell_src[q] the cell's flat slot b*L + l; (0, 0) for
// a cell of padding (src -1). One 8-byte record a cell; the weight is the
// only scattered read.
__global__ void slot_records_kernel(const float* __restrict__ weights,
                                    const int32_t* __restrict__ cell_src,
                                    int2* __restrict__ rec, int n_cells,
                                    int L) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < n_cells) {
    const int src = __ldg(cell_src + q);
    rec[q] = src < 0 ? make_int2(0, 0)
                     : make_int2(src / L, __float_as_int(__ldg(weights + src)));
  }
}

// One pass over the bags [b_lo, b_hi), columns blockIdx.y * DT ... + DT - 1.
// The block stages g[b_lo:b_hi, cols] in shared memory once. Then each warp
// walks slices of 32 rows: lane i of slice s owns the row at position
// 32 s + i of the plan's row order (heaviest first), whose j-th slot is
// record rec[slice_offsets[s] + 32 j + i], so a warp's load of one j is 256
// contiguous bytes. Warp w (of all the grid's warps of this column slice)
// walks slices warp_slices[warp_starts[w] : warp_starts[w + 1]], the
// host's schedule. A lane adds its row's slots j in
// [j_begin, j_end) in order (0 and lens[pos] for one pass), kUnroll
// records loaded before any is used. The sum starts at 0 (first pass) or
// at partial (f32); the last pass writes out in T, the others partial.
template <typename T, int DT>
__global__ void __launch_bounds__(kScatterThreads)
    bag_scatter_kernel(const float* __restrict__ g, const int2* __restrict__ rec,
                       const int32_t* __restrict__ rows,
                       const int32_t* __restrict__ lens,
                       const int32_t* __restrict__ slice_offsets,
                       const int32_t* __restrict__ warp_slices,
                       const int32_t* __restrict__ warp_starts,
                       const int32_t* __restrict__ j_begin,
                       const int32_t* __restrict__ j_end,
                       float* __restrict__ partial, T* __restrict__ out,
                       int n_rows, int D, int b_lo, int b_hi, int vec,
                       bool first, bool last) {
  constexpr int kStride = smem_stride(DT);
  constexpr int kPiece = DT < 4 ? DT : 4;  // elements a store
  extern __shared__ float4 smem4[];
  float* const gs = reinterpret_cast<float*>(smem4);
  const int col0 = blockIdx.y * DT;

  const int per_bag = DT / vec;
  const int pieces = (b_hi - b_lo) * per_bag;
  for (int p = threadIdx.x; p < pieces; p += blockDim.x) {
    const int b = p / per_bag;
    const int q = (p - b * per_bag) * vec;
    cp_async(gs + b * kStride + q,
             g + static_cast<int64_t>(b_lo + b) * D + col0 + q, vec * 4);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int w = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const int k_end = __ldg(warp_starts + w + 1);
  for (int k = __ldg(warp_starts + w); k < k_end; ++k) {
    const int s = __ldg(warp_slices + k);
    const int pos = s * kWarp + lane;
    const bool mine = pos < n_rows;
    const int64_t row = mine ? __ldg(rows + pos) : 0;
    const int jb = mine && j_begin ? __ldg(j_begin + pos) : 0;
    const int je = !mine ? 0 : j_end ? __ldg(j_end + pos) : __ldg(lens + pos);
    const int2* cells = rec + __ldg(slice_offsets + s) + lane;
    float acc[DT];
#pragma unroll
    for (int q = 0; q < DT; ++q) {
      acc[q] = first || !mine ? 0.f : partial[row * D + col0 + q];
    }
    const int lo = __reduce_min_sync(0xffffffffu, mine ? jb : INT_MAX);
    const int hi = __reduce_max_sync(0xffffffffu, je);
    for (int j0 = lo; j0 < hi; j0 += kUnroll) {
      uint2 r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        r[u] = uint2{};
        const int j = j0 + u;
        load_if(r[u], cells + static_cast<int64_t>(j) * kWarp, j >= jb && j < je);
      }
      // the plan's order: the same additions on every call
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u;
        if (j >= jb && j < je) {
          add_row<DT>(acc, __uint_as_float(r[u].y),
                      gs + (static_cast<int>(r[u].x) - b_lo) * kStride);
        }
      }
    }
    if (!mine) continue;
    if (last) {
#pragma unroll
      for (int q = 0; q < DT; q += kPiece) {
        store_vec<T, kPiece>(out + row * D + col0 + q, acc + q);
      }
    } else {
#pragma unroll
      for (int q = 0; q < DT; ++q) partial[row * D + col0 + q] = acc[q];
    }
  }
}

// ---------------------------------------------------------- B. bag dot
// threads a block of the bag dot, and blocks an SM must hold: the launch
// bounds give a thread 64 registers, 32 warps an SM
constexpr int kDotThreads = 256;
constexpr int kDotMinBlocks = 4;
// most partial sums a lane holds: the slots of a lane group a round, all
// of whose rows a lane has in flight at once
constexpr int kDotPartials = 8;

// The lanes of a group of G hold NP partial sums each, partial k of lane j
// over lane j's columns of slot k. Recursive halving: at each of log2(NP)
// steps a lane keeps one half of its partials, sends the other half to
// the lane `o` apart and adds what that lane sent; then butterfly steps
// join the lanes that hold the same slot. Lane j ends with the full sum
// of slot j / (G / NP): at G = 32 and NP = 8, 4 + 2 + 1 + 1 + 1 = 9
// shuffles for 8 slots, where a butterfly a slot takes 40. Each sum is
// formed in one lane, in a fixed order.
template <int G, int NP>
__device__ __forceinline__ float transpose_reduce(float (&p)[NP], int j) {
#pragma unroll
  for (int step = 0; (1 << step) < G; ++step) {
    const int o = G >> (step + 1);
    const int m = NP >> step;  // partials a lane still holds
    if (m > 1) {
      const bool upper = (j & o) != 0;
#pragma unroll
      for (int i = 0; i < m / 2; ++i) {
        const float send = upper ? p[i] : p[i + m / 2];
        const float keep = upper ? p[i + m / 2] : p[i];
        p[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    } else {
      p[0] += __shfl_xor_sync(0xffffffffu, p[0], o);
    }
  }
  return p[0];
}

// v = EPL floats at p (aligned to min(16, 4 EPL) bytes) where pred, in
// loads of at most 16 bytes
template <int EPL>
__device__ __forceinline__ void load_floats(float (&v)[EPL], const float* p,
                                            bool pred) {
  constexpr int P = EPL < 4 ? EPL : 4;  // floats a load
  using Raw = typename RawVec<P * sizeof(float)>::type;
#pragma unroll
  for (int q = 0; q < EPL; q += P) {
    Raw r = Raw{};
    load_if(r, p + q, pred);
    memcpy(v + q, &r, sizeof(Raw));
  }
}

// One warp walks `span` slots of one bag: warp w is bag w / spans_per_bag,
// slots from (w % spans_per_bag) * span to the bag's end at most. It takes
// them 32 at a time: lane i loads the id of slot i of the next 32 while
// the rows of these 32 are read, so no id load waits in front of a row
// load, and puts them in shared memory for the groups. A round is S =
// (32 / G) * NP of those slots: group q of G lanes takes NP of them, lane
// j of the group reading columns j * EPL, + G * EPL, ... of each row (one
// load of EPL elements a row and pass), all NP rows in flight, and
// summing g[bag, c] * row[c] in column order into partial k. g's row is
// loaded once a warp where one pass covers it. transpose_reduce leaves
// each slot's sum in the first of the lanes that hold it, which stores it.
template <typename T, int EPL, int G>
__global__ void __launch_bounds__(kDotThreads, kDotMinBlocks)
    bag_dot_kernel(const T* __restrict__ table,
                   const int32_t* __restrict__ ids,
                   const float* __restrict__ g, float* __restrict__ out,
                   int64_t warps, int spans_per_bag, int span, int L, int D) {
  constexpr int NP = G < kDotPartials ? G : kDotPartials;
  constexpr int S = kWarp / G * NP;  // slots a round, at most 32
  constexpr int kCols = G * EPL;     // columns a pass over a row
  constexpr int kCopies = G / NP;    // lanes that end with the same slot
  using RawT = typename RawVec<EPL * sizeof(T)>::type;
  __shared__ __align__(16) int32_t warp_ids[kDotThreads / kWarp][kWarp];
  const int lane = threadIdx.x % kWarp;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) +
                    threadIdx.x / kWarp;
  if (w >= warps) return;  // uniform over the warp
  const int64_t bag = w / spans_per_bag;
  const int begin = static_cast<int>(w - bag * spans_per_bag) * span;
  const int end = L - begin < span ? L : begin + span;
  const int32_t* bag_ids = ids + bag * L;
  const float* bag_g = g + bag * D;
  float* bag_out = out + bag * L;
  int32_t* const my_ids = warp_ids[threadIdx.x / kWarp];
  const int j = lane % G;
  const int s0 = lane / G * NP;  // the group's first slot in a round

  float gv[EPL];  // this lane's columns of g, for the one pass
  load_floats(gv, bag_g + j * EPL, D <= kCols && j * EPL < D);
  int32_t next = begin + lane < end ? __ldg(bag_ids + begin + lane) : 0;
  for (int c0 = begin; c0 < end; c0 += kWarp) {
    __syncwarp();  // the last 32 ids are read
    my_ids[lane] = next;
    __syncwarp();
    const int n = end - c0 < kWarp ? end - c0 : kWarp;  // slots of these 32
    if (c0 + kWarp + lane < end) next = __ldg(bag_ids + c0 + kWarp + lane);
    for (int r0 = 0; r0 < n; r0 += S) {
      float p[NP];
#pragma unroll
      for (int k = 0; k < NP; ++k) p[k] = 0.f;
      // no shuffle in this loop: lanes past D leave it early
      for (int c = j * EPL; c < D; c += kCols) {
        if (D > kCols) load_floats(gv, bag_g + c, true);
        int32_t id[NP];
        if constexpr (NP % 4 == 0) {
#pragma unroll
          for (int q = 0; q < NP; q += 4) {
            const int4 v = *reinterpret_cast<const int4*>(my_ids + r0 + s0 + q);
            id[q] = v.x;
            id[q + 1] = v.y;
            id[q + 2] = v.z;
            id[q + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int k = 0; k < NP; ++k) id[k] = my_ids[r0 + s0 + k];
        }
        RawT r[NP];
#pragma unroll
        for (int k = 0; k < NP; ++k) {
          const bool in = r0 + s0 + k < n;
          r[k] = RawT{};
          load_if(r[k], table + static_cast<int64_t>(in ? id[k] : 0) * D + c, in);
        }
#pragma unroll
        for (int k = 0; k < NP; ++k) {
          const T* v = reinterpret_cast<const T*>(&r[k]);
#pragma unroll
          for (int e = 0; e < EPL; ++e) p[k] += gv[e] * to_f32(v[e]);
        }
      }
      const float sum = transpose_reduce<G, NP>(p, j);
      const int s = r0 + s0 + j / kCopies;
      if (j % kCopies == 0 && s < n) bag_out[c0 + s] = sum;
    }
  }
}

// Kernel A's geometry (embedding.py: ScatterGeometry), as it is launched:
// DT columns a block, `vec` floats a g copy, `threads` a block,
// `chunk_bags` bags of g staged a pass (all B when they fit: one pass),
// grid (grid_x blocks sharing the rows, grid_y column slices).
struct ScatterGeometry {
  int dt, vec, threads, chunk_bags, grid_x, grid_y;
};

// most shared memory a block takes on the H100 (opt-in dynamic)
constexpr int kScatterSmemBytes = 227 * 1024;

int64_t scatter_smem_bytes(const ScatterGeometry& geo) {
  return static_cast<int64_t>(geo.chunk_bags) * smem_stride(geo.dt) *
         static_cast<int64_t>(sizeof(float));
}

bool scatter_geometry_ok(const ScatterGeometry& geo, int D) {
  const bool dt_ok = geo.dt == 16 || geo.dt == 8 || geo.dt == 4 ||
                     geo.dt == 2 || geo.dt == 1;
  const bool vec_ok = geo.vec == 4 || geo.vec == 2 || geo.vec == 1;
  return dt_ok && vec_ok && geo.dt % geo.vec == 0 && D % geo.dt == 0 &&
         static_cast<int64_t>(geo.grid_y) * geo.dt == D &&
         geo.grid_y <= 65535 && geo.threads >= kWarp &&
         geo.threads % kWarp == 0 && geo.threads <= kScatterThreads &&
         geo.grid_x >= 1 && geo.chunk_bags >= 1 &&
         scatter_smem_bytes(geo) <= kScatterSmemBytes;
}

template <typename T, int DT>
int scatter_dt(const float* g, const float* weights, const int32_t* cell_src,
               const int32_t* rows, const int32_t* lens,
               const int32_t* slice_offsets, const int32_t* warp_slices,
               const int32_t* warp_starts, const int32_t* j_starts, int2* rec,
               float* partial, T* out, int n_rows, int B, int L, int D,
               int n_cells, const ScatterGeometry& geo, cudaStream_t stream) {
  const int64_t smem = scatter_smem_bytes(geo);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bag_scatter_kernel<T, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kScatterSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_cells > 0) {
    slot_records_kernel<<<(n_cells - 1) / 256 + 1, 256, 0, stream>>>(
        weights, cell_src, rec, n_cells, L);
  }
  const int passes = B > 0 ? (B - 1) / geo.chunk_bags + 1 : 1;
  for (int p = 0; p < passes; ++p) {
    const int b_lo = p * geo.chunk_bags;
    const int b_hi = B < b_lo + geo.chunk_bags ? B : b_lo + geo.chunk_bags;
    // a row's slots in this pass: from the pass's start to the next one's
    // (null: the row's first slot, or its end)
    const int32_t* begin =
        p == 0 ? nullptr : j_starts + static_cast<int64_t>(p - 1) * n_rows;
    const int32_t* end =
        p == passes - 1 ? nullptr : j_starts + static_cast<int64_t>(p) * n_rows;
    bag_scatter_kernel<T, DT>
        <<<dim3(geo.grid_x, geo.grid_y), geo.threads, smem, stream>>>(
            g, rec, rows, lens, slice_offsets, warp_slices, warp_starts, begin,
            end, partial, out, n_rows, D, b_lo, b_hi, geo.vec, p == 0,
            p == passes - 1);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int scatter(const void* g, const void* weights, const void* cell_src,
            const void* rows, const void* lens, const void* slice_offsets,
            const void* warp_slices, const void* warp_starts,
            const void* j_starts, void* rec, void* partial, void* out,
            int n_rows, int B, int L, int D, int n_cells,
            const ScatterGeometry& geo, void* stream) {
  const bool several = B > geo.chunk_bags;
  if (n_rows < 1 || B < 0 || n_cells < 0 || (n_cells > 0 && L < 1) ||
      !scatter_geometry_ok(geo, D) ||
      (several && (j_starts == nullptr || partial == nullptr)) ||
      (B > 0 && (D % geo.vec != 0 || !aligned(g, geo.vec * sizeof(float)))) ||
      !aligned(rec, 8) || !aligned(out, 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* gf = static_cast<const float*>(g);
  const auto* wf = static_cast<const float*>(weights);
  const auto* cs = static_cast<const int32_t*>(cell_src);
  const auto* rw = static_cast<const int32_t*>(rows);
  const auto* ln = static_cast<const int32_t*>(lens);
  const auto* so = static_cast<const int32_t*>(slice_offsets);
  const auto* ws = static_cast<const int32_t*>(warp_slices);
  const auto* wst = static_cast<const int32_t*>(warp_starts);
  const auto* js = static_cast<const int32_t*>(j_starts);
  auto* rc = static_cast<int2*>(rec);
  auto* pt = static_cast<float*>(partial);
  auto* o = static_cast<T*>(out);
  switch (geo.dt) {
    case 16:
      return scatter_dt<T, 16>(gf, wf, cs, rw, ln, so, ws, wst, js, rc, pt, o,
                               n_rows, B, L, D, n_cells, geo, s);
    case 8:
      return scatter_dt<T, 8>(gf, wf, cs, rw, ln, so, ws, wst, js, rc, pt, o,
                              n_rows, B, L, D, n_cells, geo, s);
    case 4:
      return scatter_dt<T, 4>(gf, wf, cs, rw, ln, so, ws, wst, js, rc, pt, o,
                              n_rows, B, L, D, n_cells, geo, s);
    case 2:
      return scatter_dt<T, 2>(gf, wf, cs, rw, ln, so, ws, wst, js, rc, pt, o,
                              n_rows, B, L, D, n_cells, geo, s);
    default:
      return scatter_dt<T, 1>(gf, wf, cs, rw, ln, so, ws, wst, js, rc, pt, o,
                              n_rows, B, L, D, n_cells, geo, s);
  }
}

// blocks of `kernel` an SM holds with this block size and shared memory,
// or minus the CUDA error
template <typename Kernel>
int occupancy_of(Kernel kernel, int threads, int smem) {
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kScatterSmemBytes);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                        smem);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <typename T>
int scatter_occupancy(int dt, int threads, int smem) {
  switch (dt) {
    case 16:
      return occupancy_of(bag_scatter_kernel<T, 16>, threads, smem);
    case 8:
      return occupancy_of(bag_scatter_kernel<T, 8>, threads, smem);
    case 4:
      return occupancy_of(bag_scatter_kernel<T, 4>, threads, smem);
    case 2:
      return occupancy_of(bag_scatter_kernel<T, 2>, threads, smem);
    case 1:
      return occupancy_of(bag_scatter_kernel<T, 1>, threads, smem);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// Kernel B's geometry (embedding.py: DotGeometry), as it is launched:
// elements a lane loads at once, lanes a group, slots a warp walks (a
// multiple of 32), grid x and threads a block.
struct DotGeometry {
  int epl, group_lanes, span, grid_x, threads;
};

bool dot_geometry_ok(const DotGeometry& geo, int64_t warps) {
  const int gl = geo.group_lanes;
  return gl >= 1 && gl <= kWarp && (gl & (gl - 1)) == 0 &&
         geo.threads >= kWarp && geo.threads % kWarp == 0 &&
         geo.threads <= kDotThreads && geo.grid_x >= 1 &&
         static_cast<int64_t>(geo.grid_x) * (geo.threads / kWarp) >= warps;
}

template <typename T, int EPL, int G>
int dot_launch(const T* table, const int32_t* ids, const float* g, float* out,
               int64_t warps, int spans_per_bag, int L, int D,
               const DotGeometry& geo, cudaStream_t stream) {
  bag_dot_kernel<T, EPL, G><<<geo.grid_x, geo.threads, 0, stream>>>(
      table, ids, g, out, warps, spans_per_bag, geo.span, L, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int EPL>
int dot_epl(const void* table, const void* ids, const void* g, void* out,
            int B, int L, int D, const DotGeometry& geo, cudaStream_t stream) {
  if (geo.span < kWarp || geo.span % kWarp != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int spans_per_bag = (L - 1) / geo.span + 1;
  const int64_t warps = static_cast<int64_t>(B) * spans_per_bag;
  const int g_align = EPL < 4 ? EPL * sizeof(float) : 16;
  if (!dot_geometry_ok(geo, warps) || D % EPL != 0 ||
      !aligned(table, EPL * sizeof(T)) || !aligned(g, g_align)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* t = static_cast<const T*>(table);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* gf = static_cast<const float*>(g);
  auto* o = static_cast<float*>(out);
  switch (geo.group_lanes) {
    case 32:
      return dot_launch<T, EPL, 32>(t, i, gf, o, warps, spans_per_bag, L, D, geo, stream);
    case 16:
      return dot_launch<T, EPL, 16>(t, i, gf, o, warps, spans_per_bag, L, D, geo, stream);
    case 8:
      return dot_launch<T, EPL, 8>(t, i, gf, o, warps, spans_per_bag, L, D, geo, stream);
    case 4:
      return dot_launch<T, EPL, 4>(t, i, gf, o, warps, spans_per_bag, L, D, geo, stream);
    case 2:
      return dot_launch<T, EPL, 2>(t, i, gf, o, warps, spans_per_bag, L, D, geo, stream);
    default:
      return dot_launch<T, EPL, 1>(t, i, gf, o, warps, spans_per_bag, L, D, geo, stream);
  }
}

// a lane loads at most 16 bytes of a row: 8 elements of a bf16 table
template <typename T>
int dot(const void* table, const void* ids, const void* g, void* out, int B,
        int L, int D, const DotGeometry& geo, void* stream) {
  if (B < 1 || L < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (geo.epl) {
    case 8:
      if constexpr (sizeof(T) == 2) {
        return dot_epl<T, 8>(table, ids, g, out, B, L, D, geo, s);
      }
      return static_cast<int>(cudaErrorInvalidValue);
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

// Plain C interface, loaded with ctypes. Each returns cudaGetLastError()
// after the launch (0 = cudaSuccess), or cudaErrorInvalidValue without
// launching for a geometry or an alignment it cannot run.
//
// Kernel A: g f32 [B, D], weights f32 [B, L], and the plan in its sliced
// layout: cell_src int32 [n_cells] (each cell's flat slot b*L + l, -1 for
// padding), rows int32 [n_rows] (the rows by slot count, heaviest first),
// lens int32 [n_rows] (their counts), slice_offsets int32 [n_slices + 1]
// (slice s of rows 32 s ... 32 s + 31 has its cells from slice_offsets[s],
// 32 a slot j); the schedule warp_slices int32 [n_slices] and warp_starts
// int32 [grid_x * threads / 32 + 1]; j_starts int32 [passes - 1, n_rows],
// the first slot j of each position's row whose bag is in pass p = 1, 2,
// ... (null for one pass); scratch rec int2 [n_cells] and, for more than
// one pass, partial f32 [n_rows, D] → out [n_rows, D], 16-byte aligned.
// The six ints before the stream are the host's ScatterGeometry. It
// launches slot_records_kernel (one thread a cell, where n_cells > 0),
// then the bag scatter once a pass. Requires n_rows >= 1 and D >= 1.
#define PIO_BAG_SCATTER_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* g, const void* weights,                      \
                      const void* cell_src, const void* rows,                  \
                      const void* lens, const void* slice_offsets,             \
                      const void* warp_slices, const void* warp_starts,        \
                      const void* j_starts, void* rec, void* partial,          \
                      void* out, int n_rows, int B, int L, int D, int n_cells, \
                      int dt, int vec, int threads, int chunk_bags,            \
                      int grid_x, int grid_y, void* stream) {                  \
    const ScatterGeometry geo{dt, vec, threads, chunk_bags, grid_x, grid_y};   \
    return scatter<T>(g, weights, cell_src, rows, lens, slice_offsets,         \
                      warp_slices, warp_starts, j_starts, rec, partial, out,   \
                      n_rows, B, L, D, n_cells, geo, stream);                  \
  }

// Blocks of kernel A (table type T) an SM holds at DT columns, `threads` a
// block and `smem` bytes of shared memory; minus the CUDA error on failure.
#define PIO_BAG_SCATTER_OCCUPANCY(NAME, T)                                     \
  extern "C" int NAME(int dt, int threads, int smem) {                         \
    return scatter_occupancy<T>(dt, threads, smem);                            \
  }

// Kernel B: table [V, D], ids int32 [B, L], g f32 [B, D] → out f32 [B, L].
// The five ints before the stream are the host's DotGeometry: elements a
// lane, lanes a group, slots a warp, grid x and threads a block. Requires
// B >= 1, L >= 1 and D >= 1.
#define PIO_BAG_DOT_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* table, const void* ids, const void* g,     \
                      void* out, int B, int L, int D, int epl,               \
                      int group_lanes, int span, int grid_x, int threads,    \
                      void* stream) {                                        \
    const DotGeometry geo{epl, group_lanes, span, grid_x, threads};          \
    return dot<T>(table, ids, g, out, B, L, D, geo, stream);                 \
  }

PIO_BAG_SCATTER_ENTRY(pio_bag_scatter_f32, float)
PIO_BAG_SCATTER_ENTRY(pio_bag_scatter_bf16, __nv_bfloat16)
PIO_BAG_SCATTER_OCCUPANCY(pio_bag_scatter_occupancy_f32, float)
PIO_BAG_SCATTER_OCCUPANCY(pio_bag_scatter_occupancy_bf16, __nv_bfloat16)
PIO_BAG_DOT_ENTRY(pio_bag_dot_f32, float)
PIO_BAG_DOT_ENTRY(pio_bag_dot_bf16, __nv_bfloat16)
