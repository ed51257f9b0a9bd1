// K1: sum of receiver-sorted edge rows into their nodes.
//
//   out[n, :] = sum of data[e, :] for e in [splits[n], splits[n+1])
//
// Replaces the TPU kernel _seg_sum_kernel of
// gcpnet_tpu/ops/pallas_segment.py (pallas_call at :160), which
// segment_sum_sorted reaches through _seg_sum_fwd_impl.  Ranges are clamped
// to the rows that exist, so rows at or after splits[num_nodes] belong to
// no node, and an empty range gives 0.
//
// Bound on the H100: bytes.  The function reads each in-range row once and
// writes [N, D] once, about one addition per element read: at the main
// path's shape (208,896 x 148 rows into 7,168 nodes) that is ~62 MB in bf16,
// ~19 us at 3.35 TB/s.  The TPU kernel builds one-hot matrices for the
// matrix unit because the TPU has no fast scatter; that is not carried
// over.  Rows are sorted, so each node's rows are contiguous and a CSR
// segmented reduction needs no atomics: one warp per node, each lane owning
// 4-wide column groups loaded as one 16-byte (f32) or 8-byte (bf16) vector,
// float32 accumulators in registers, one store in the input dtype.  Eight
// warps per block and many blocks per SM keep enough independent loads in
// flight to stream at memory rate.

#include "common.cuh"

namespace {

using gcp::to_f;
using gcp::store_f;

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxGroups = 2;  // 4-wide column groups per lane: dim <= 256

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void node_range(const int* splits, int node, long long rows,
                                           long long* lo, long long* hi) {
  const long long a = max(0LL, min(static_cast<long long>(splits[node]), rows));
  const long long b = max(a, min(static_cast<long long>(splits[node + 1]), rows));
  *lo = a;
  *hi = b;
}

// dim % 4 == 0, dim <= 128 * kMaxGroups, 16-byte (f32) / 8-byte (bf16)
// aligned rows.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
seg_sum_vec4(const T* __restrict__ data, const int* __restrict__ splits, T* __restrict__ out,
             long long rows, int num_nodes, int dim) {
  const int node = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (node >= num_nodes) return;
  long long lo, hi;
  node_range(splits, node, rows, &lo, &hi);
  const int groups = dim >> 2;
  float acc[kMaxGroups][4] = {};
#pragma unroll 4
  for (long long e = lo; e < hi; ++e) {
    const T* row = data + e * dim;
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      const int grp = lane + 32 * g;
      if (grp < groups) {
        float v[4];
        load4(row + 4 * grp, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[g][j] += v[j];
      }
    }
  }
  T* orow = out + static_cast<long long>(node) * dim;
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    const int grp = lane + 32 * g;
    if (grp < groups) store4(orow + 4 * grp, acc[g]);
  }
}

// Any dim and alignment: lanes walk the columns 32 at a time.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
seg_sum_scalar(const T* __restrict__ data, const int* __restrict__ splits, T* __restrict__ out,
               long long rows, int num_nodes, int dim) {
  const int node = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (node >= num_nodes) return;
  long long lo, hi;
  node_range(splits, node, rows, &lo, &hi);
  for (int col = lane; col < dim; col += 32) {
    float acc = 0.f;
    for (long long e = lo; e < hi; ++e) acc += to_f(data[e * dim + col]);
    store_f(out + static_cast<long long>(node) * dim + col, acc);
  }
}

template <typename T>
int launch(const void* data, const int* splits, void* out, long long rows, int num_nodes,
           int dim, cudaStream_t stream) {
  const T* d = static_cast<const T*>(data);
  T* o = static_cast<T*>(out);
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = dim % 4 == 0 && dim <= 128 * kMaxGroups &&
                   reinterpret_cast<uintptr_t>(d) % align == 0 &&
                   reinterpret_cast<uintptr_t>(o) % align == 0;
  const dim3 grid((num_nodes + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  if (vec) {
    seg_sum_vec4<T><<<grid, block, 0, stream>>>(d, splits, o, rows, num_nodes, dim);
  } else {
    seg_sum_scalar<T><<<grid, block, 0, stream>>>(d, splits, o, rows, num_nodes, dim);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// data [rows, dim], splits [num_nodes + 1] int32, out [num_nodes, dim], all
// on the device; dtype is a gcp::DType.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int gcp_segment_sum_sorted(const void* data, const int* splits, void* out,
                                      long long rows, int num_nodes, int dim, int dtype,
                                      void* stream) {
  if (num_nodes <= 0 || dim <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == gcp::kF32) return launch<float>(data, splits, out, rows, num_nodes, dim, s);
  if (dtype == gcp::kBF16) return launch<__nv_bfloat16>(data, splits, out, rows, num_nodes, dim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
