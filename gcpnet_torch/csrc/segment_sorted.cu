// K1: sum of receiver-sorted edge rows into their nodes.
//
//   out[n, :] = sum of data[e, :] for e in [splits[n], splits[n+1])
//
// Replaces the TPU kernel _seg_sum_kernel of
// gcpnet_tpu/ops/pallas_segment.py (pallas_call at :160), which
// segment_sum_sorted reaches through _seg_sum_fwd_impl.  Ranges are clamped
// to the rows that exist, so rows at or after splits[num_nodes] belong to
// no node, and an empty range gives 0.  The splits are non-decreasing (the
// receiver sort makes them so): node n's rows are contiguous and follow
// node n-1's.
//
// Bound on the H100: bytes.  The function reads each in-range row once and
// writes [N, D] once, about one addition per element read: at the main
// path's shape (208,896 x 148 rows into 7,168 nodes) that is ~64 MB in bf16,
// ~19 us at 3.35 TB/s.  The TPU kernel builds one-hot matrices for the
// matrix unit because the TPU has no fast scatter; that is not carried
// over.
//
// Design: a block owns kNodes consecutive nodes, whose rows are one
// contiguous stretch of memory.  Its threads stream that stretch as
// (row, column group) pairs, S rows at a time, so that neighbouring threads
// read neighbouring vectors and every warp-wide load is whole: thread
// (s, g) reads group g (V columns: one 16-byte vector in f32, 8 bytes in
// bf16) of rows s, s + S, s + 2S, ..., kUnroll rows loaded before any is
// added, and keeps a float32 sum for the node it is in.  When its next row
// belongs to a later node it leaves that sum in shared memory at (node, s,
// g); each such slot is written by one thread at most, once.  Then each
// (node, g) adds its S slices in order and stores once in the input dtype.
// No atomics: the result is the same from run to run.  Columns that are not
// a multiple of 4 take the same kernel with V = 1.

#include "common.cuh"

namespace {

using gcp::store_f;
using gcp::to_f;

constexpr int kThreads = 128;
constexpr int kNodes = 4;   // consecutive nodes per block
constexpr int kUnroll = 8;  // rows in flight per thread

template <int V>
struct Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load(const float* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = x.x; r.v[1] = x.y; r.v[2] = x.z; r.v[3] = x.w;
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

template <int V>
__device__ __forceinline__ Vec<V> load(const __nv_bfloat16* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    r.v[0] = a.x; r.v[1] = a.y; r.v[2] = b.x; r.v[3] = b.y;
  } else {
    r.v[0] = to_f(p[0]);
  }
  return r;
}

__device__ __forceinline__ void store(float* p, const float* v, int n) {
  if (n == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < n; ++j) p[j] = v[j];
  }
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v, int n) {
  if (n == 4) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&a);
    raw.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
    for (int j = 0; j < n; ++j) store_f(p + j, v[j]);
  }
}

__device__ __forceinline__ long long clamp_row(int split, long long rows) {
  return max(0LL, min(static_cast<long long>(split), rows));
}

// Block (x, y) sums nodes [x * kNodes, +kNodes) over column groups
// [y * gc, +gc) of V columns; dim is a multiple of V and, for V = 4, rows
// are 16-byte (f32) / 8-byte (bf16) aligned.  Dynamic shared memory:
// kNodes * (kThreads / gc) * gc * V floats.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
seg_sum(const T* __restrict__ data, const int* __restrict__ splits, T* __restrict__ out,
        long long rows, int num_nodes, int dim, int gc) {
  extern __shared__ float part[];  // [kNodes][S][gc][V]
  __shared__ long long ends[kNodes + 1];
  const int n0 = blockIdx.x * kNodes;
  const int nb = min(kNodes, num_nodes - n0);
  const int groups = dim / V;
  const int g0 = blockIdx.y * gc;
  const int gn = min(gc, groups - g0);  // groups of this block
  const int slices = kThreads / gc;
  const int tid = threadIdx.x;
  // ends[j]: the end of node n0 + j - 1's rows (ends[0]: the block's first
  // row), each clamped to the rows that exist and to the previous end
  if (tid <= nb) ends[tid] = clamp_row(splits[n0 + tid], rows);
  const int part_len = kNodes * slices * gc * V;
  for (int i = tid; i < part_len; i += kThreads) part[i] = 0.f;
  __syncthreads();
  if (tid == 0)
    for (int j = 1; j <= nb; ++j) ends[j] = max(ends[j], ends[j - 1]);
  __syncthreads();

  const int s = tid / gc, g = tid - s * gc;
  if (s < slices && g < gn) {
    const long long first = ends[0], last = ends[nb];
    const T* col = data + static_cast<long long>(g0 + g) * V;
    int node = 0;  // local index of the node of the rows being summed
    float acc[V] = {};
    for (long long r0 = first + s; r0 < last; r0 += static_cast<long long>(kUnroll) * slices) {
      Vec<V> x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = r0 + static_cast<long long>(u) * slices;
        if (r < last) x[u] = load<V>(col + r * dim);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = r0 + static_cast<long long>(u) * slices;
        if (r >= last) break;
        while (r >= ends[node + 1]) {  // leave the sum of the node this row is past
          float* slot = part + ((node * slices + s) * gc + g) * V;
#pragma unroll
          for (int j = 0; j < V; ++j) {
            slot[j] = acc[j];
            acc[j] = 0.f;
          }
          ++node;
        }
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += x[u].v[j];
      }
    }
    if (first < last) {
      float* slot = part + ((node * slices + s) * gc + g) * V;
#pragma unroll
      for (int j = 0; j < V; ++j) slot[j] = acc[j];
    }
  }
  __syncthreads();
  // each (node, group): its slices in order, one store
  for (int i = tid; i < nb * gn; i += kThreads) {
    const int j = i / gn, gg = i - j * gn;
    float sum[V] = {};
    for (int q = 0; q < slices; ++q) {
      const float* slot = part + ((j * slices + q) * gc + gg) * V;
#pragma unroll
      for (int k = 0; k < V; ++k) sum[k] += slot[k];
    }
    store(out + static_cast<long long>(n0 + j) * dim + static_cast<long long>(g0 + gg) * V, sum, V);
  }
}

template <typename T, int V>
int launch_v(const T* data, const int* splits, T* out, long long rows, int num_nodes, int dim,
             cudaStream_t stream) {
  const int groups = dim / V;
  const int gc = min(groups, kThreads);
  const dim3 grid((num_nodes + kNodes - 1) / kNodes, (groups + gc - 1) / gc);
  const size_t smem = sizeof(float) * kNodes * (kThreads / gc) * gc * V;
  seg_sum<T, V><<<grid, kThreads, smem, stream>>>(data, splits, out, rows, num_nodes, dim, gc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* data, const int* splits, void* out, long long rows, int num_nodes,
           int dim, cudaStream_t stream) {
  const T* d = static_cast<const T*>(data);
  T* o = static_cast<T*>(out);
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = dim % 4 == 0 && reinterpret_cast<uintptr_t>(d) % align == 0 &&
                   reinterpret_cast<uintptr_t>(o) % align == 0;
  if (vec) return launch_v<T, 4>(d, splits, o, rows, num_nodes, dim, stream);
  return launch_v<T, 1>(d, splits, o, rows, num_nodes, dim, stream);
}

}  // namespace

// data [rows, dim], splits [num_nodes + 1] int32 (non-decreasing), out
// [num_nodes, dim], all on the device; dtype is a gcp::DType.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int gcp_segment_sum_sorted(const void* data, const int* splits, void* out,
                                      long long rows, int num_nodes, int dim, int dtype,
                                      void* stream) {
  if (num_nodes <= 0 || dim <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == gcp::kF32) return launch<float>(data, splits, out, rows, num_nodes, dim, s);
  if (dtype == gcp::kBF16) return launch<__nv_bfloat16>(data, splits, out, rows, num_nodes, dim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
