// K2: the GCP2 message stack, fused over tiles of edge rows, on the tensor
// cores.
//
//   out[e, :] = stack(message[e, :], frames[e, :])
//
// Replaces the TPU forward kernel of gcpnet_tpu/ops/pallas_fused.py
// (_map_impl, pallas_call at :117) as gcpnet_tpu/nn/message_passing.py:673-691
// runs it: the whole ResGCP2 message stack (apply_stack over
// _fast_gcp2_layer_mm) on on-chip blocks of edge rows.
//
// Per edge row and layer (dims s_in, v_in -> s_out, v_out; vector hidden h;
// packed vectors [x | y | z], component c):
//   vh_c  = v_c @ Wd,   df_c = v_c @ Wdf
//   vnorm = sqrt(sum_c vh_c^2 + 1e-8) + 1e-8
//   scal9[ch*3 + f] = sum_a df_a[ch] * frame[3f + a]     (frames pre-masked)
//   s_new = [s | vnorm | scal9] @ Wso + bso
//   vu_c  = vh_c @ Wup  (+ v_c with the vector residual)
//   vu_c *= sigmoid(act_v(s_new) @ Wg + bg)              (vector gate), or
//   vu_c *= act_v(sqrt(sum_c vu_c^2 + 1e-8) + 1e-8)      (norm gate)
//   (s, v) = (act_s(s_new), vu), summed over layers for ResGCP.
// act_s and act_v are the identity, relu, leaky relu (x >= 0 ? x : slope x,
// the slope per layer) or silu (x sigmoid(x)) here; the wrapper raises for
// any other setting.
//
// Bound on the H100: operations.  About 245 kFLOP per edge row against
// about 1 KB of traffic: ~51 GFLOP and ~208 MB (bf16) per call at the main
// path's shape (208,896 edge rows, hidden 100/16, 8 layers), 0.052 ms at the
// bf16 tensor-core peak; float32 on split TF32 does three products for
// each, 0.31 ms at the TF32 peak.
//
// Design (edge_stack_mma.cuh holds the layer body, shared with K3):
// - A persistent grid (one block per SM, 512 threads) walks 64-row tiles
//   (32-row ones for a stack too wide for them, layout()).
//   A tile's activations stay in shared memory through all the layers; each
//   input row is read once (16-byte vectors) and each output row written
//   once.  The TPU kernel's MM-form weights (block-diagonal and 0/1
//   selector matrices, needed only because Mosaic cannot address single
//   lane columns) are not carried over: the module-form weights are applied
//   per x/y/z component (~20% fewer operations).
// - Every product is a warp-level mma.sync fed by ldmatrix: bf16 with
//   float32 accumulators, each product's output rounded to bf16 (the JAX
//   kernel's rounding); float32 as split TF32.  K3's recompute runs the
//   same device functions, so it rebuilds this kernel's state in either
//   type.
// - Weights: one image per layer in global memory, built once per packed
//   stack (edge_map_tc_images, L2-resident, ~0.5 MB in bf16), copied into shared
//   memory by cp.async, only as far as the layer reads it.  In bf16 two
//   buffers fit beside the tile, and the next layer's image (the next
//   tile's first, after the last layer) is copied while this one computes.
//   In float32 one buffer fits (the tile's activations take ~162 KB, layer
//   0's Wso alone ~106 KB), so Wso is staged in chunks of 128 K columns
//   (two for layer 0), the next layer's first chunk is copied once this
//   layer's Wso is read, and its smaller weights once the layer's output is
//   written.
//
// k2_breakdown.py builds this file with K2_CUT set to one of edge_stack.cuh's
// K2Cut values, each removing one part of the work (the results are then
// wrong), and times the variants.

#include "edge_stack_mma.cuh"

namespace {

using gcp::Layer;
using gcp::Stack;
using namespace gcp::tc;

// The state's rows (M[:, :s_out] scalars, then X[:, :v_out] per component)
// into the tile's rows r < rows of out, as 16-byte vectors where out is
// 16-byte aligned.
template <typename T, int R>
__device__ inline void store_output(const Smem<T>& s, const Geom& g, const Layer& L, T* __restrict__ out,
                                    int rows) {
  constexpr int u = 16 / sizeof(T);
  const int width = L.s_out + 3 * L.v_out, n = rows * width;
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int i = threadIdx.x; i * u < n; i += kThreads) {
    const int e = i * u;
    alignas(16) T v[u];
    int r = e / width, col = e - r * width;
#pragma unroll
    for (int j = 0; j < u; ++j) {
      if (r < R) {
        if (col < L.s_out) {
          v[j] = s.M[r * g.ldm + col];
        } else {
          const int q = col - L.s_out, c = q / L.v_out;
          v[j] = s.X[(r * 3 + c) * g.ldx + (q - c * L.v_out)];
        }
      }
      if (++col == width) col = 0, ++r;
    }
    if (vec && e + u <= n) {
      *reinterpret_cast<uint4*>(out + e) = *reinterpret_cast<const uint4*>(v);
    } else {
      for (int j = 0; j < u && e + j < n; ++j) out[e + j] = v[j];
    }
  }
}

template <typename T, int R, bool kSilu>
__global__ void __launch_bounds__(kThreads, 1)
edge_map_tc_kernel(const T* __restrict__ msg, const T* __restrict__ frames, const char* __restrict__ images,
                   const Stack st, const Geom g, int nbuf, T* __restrict__ out, long long num_edges) {
  extern __shared__ float4 smem4[];
  Smem<T> s;
  const size_t smem_bytes = carve<T, R>(reinterpret_cast<char*>(smem4), g, &s, nbuf, false);
  // every padding column starts (and stays) zero
  for (size_t i = threadIdx.x; i < smem_bytes / sizeof(float4); i += kThreads)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int nl = st.n_layers;
  const Layer first = st.l[0], last = st.l[nl - 1];
  const int in_dim = first.s_in + 3 * first.v_in, out_dim = last.s_out + 3 * last.v_out;
  const long long num_tiles = (num_edges + R - 1) / R;
  auto image = [&](int l) { return images + static_cast<long long>(l) * g.img_bytes; };
  char* buf = s.wbase;                  // this layer's weights
  char* other = s.wbase + g.w_bytes;    // the next layer's, with two buffers
  if constexpr (gcp::kK2Staging) copy_async(buf, image(0), layer_bytes<T>(g, first));
  for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const long long e0 = tile * R;
    const int rows = static_cast<int>(min(static_cast<long long>(R), num_edges - e0));
    if constexpr (gcp::kK2InputOutput) load_input<T, R>(s, g, first, msg + e0 * in_dim, frames + e0 * 9, rows);
    for (int l = 0; l < nl; ++l) {
      const Layer L = st.l[l];
      // the next layer of this tile, or the first of the block's next tile
      const bool more = l + 1 < nl || tile + gridDim.x < num_tiles;
      const int ln = l + 1 < nl ? l + 1 : 0;
      const Layer N = st.l[ln];
      cp_async_wait();
      __syncthreads();  // this layer's weights are in; the previous layer is done with the other buffer
      carve_weights(buf, g, &s);
      if (gcp::kK2Staging && nbuf == 2 && more) copy_async(other, image(ln), layer_bytes<T>(g, N));
      layer_forward<T, R, kSilu>(s, g, L, image(l), [&] {
        if (gcp::kK2Staging && nbuf == 1 && more)
          copy_async(buf + g.w_off_wso, image(ln) + g.w_off_wso, wso_first_bytes<T>(g, N));
      });
      layer_output<T, R, kSilu>(s, g, L, st.residual && l > 0, nullptr);
      if (nbuf == 2) {
        char* t = buf;
        buf = other;
        other = t;
      } else if (gcp::kK2Staging && more) {
        copy_async(buf, image(ln), g.w_off_wso);
      }
    }
    if constexpr (gcp::kK2InputOutput) store_output<T, R>(s, g, last, out + e0 * out_dim, rows);
    __syncthreads();  // the state is stored before the next tile's input lands
  }
  cp_async_wait();
}

// Layer blockIdx.x's image (build_image) at images + layer * g.img_bytes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
edge_map_tc_images(const float* __restrict__ W, const Stack st, const Geom g, char* __restrict__ images) {
  build_image<T>(W, st.l[blockIdx.x], g, images + static_cast<size_t>(blockIdx.x) * g.img_bytes);
}

// The tile gcp_edge_map_tc launches: its rows (kTile, or half as many for a
// stack too wide for kTile's: AR's in float32), its weight buffers (2 where
// they fit, else 1) and its shared-memory bytes; rows 0: too wide for
// either.
struct Layout {
  int rows, nbuf;
  size_t smem;
};

template <typename T, int R>
bool fits(const Geom& g, Layout* out) {
  Smem<T> unused;
  for (int nbuf = 2; nbuf >= 1; --nbuf) {
    const size_t smem = carve<T, R>(nullptr, g, &unused, nbuf, false);
    if (smem <= static_cast<size_t>(kMaxSmem)) {
      *out = Layout{R, nbuf, smem};
      return true;
    }
  }
  return false;
}

template <typename T>
Layout layout(const Geom& g) {
  Layout out{0, 0, 0};
  if (!fits<T, kTile>(g, &out)) fits<T, kTile / 2>(g, &out);
  return out;
}

template <typename T, int R, bool kSilu>
int launch_rows(const void* msg, const void* frames, const void* images, const Stack& st, const Geom& g,
                const Layout& lay, void* out, long long num_edges, cudaStream_t stream) {
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(edge_map_tc_kernel<T, R, kSilu>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(lay.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (num_edges + R - 1) / R;
  const unsigned grid = static_cast<unsigned>(std::min<long long>(tiles, sms));
  edge_map_tc_kernel<T, R, kSilu><<<grid, kThreads, lay.smem, stream>>>(
      static_cast<const T*>(msg), static_cast<const T*>(frames), static_cast<const char*>(images), st, g, lay.nbuf,
      static_cast<T*>(out), num_edges);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* msg, const void* frames, const void* images, const Stack& st, void* out,
           long long num_edges, cudaStream_t stream) {
  const Geom g = geometry<T>(st);
  const Layout lay = layout<T>(g);
  if (lay.rows == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (num_edges <= 0) return 0;
  const bool silu = gcp::uses_silu(st);
  if (lay.rows == kTile)
    return silu ? launch_rows<T, kTile, true>(msg, frames, images, st, g, lay, out, num_edges, stream)
                : launch_rows<T, kTile, false>(msg, frames, images, st, g, lay, out, num_edges, stream);
  return silu ? launch_rows<T, kTile / 2, true>(msg, frames, images, st, g, lay, out, num_edges, stream)
              : launch_rows<T, kTile / 2, false>(msg, frames, images, st, g, lay, out, num_edges, stream);
}

}  // namespace

// Bytes of the per-layer weight images gcp_edge_map_tc reads, for the layer
// table meta (edge_stack.cuh parse_stack) and dtype (gcp::DType); -1 for a
// malformed table or dtype.
extern "C" long long gcp_edge_map_tc_image_bytes(const int* meta, int meta_len, int dtype) {
  Stack st;
  if (!gcp::parse_stack(meta, meta_len, st)) return -1;
  if (dtype == gcp::kF32) return static_cast<long long>(st.n_layers) * geometry<float>(st).img_bytes;
  if (dtype == gcp::kBF16) return static_cast<long long>(st.n_layers) * geometry<bf16>(st).img_bytes;
  return -1;
}

// The weight images of the stack: weights float32 [weights_len] on the
// device (the packed layout), images [gcp_edge_map_tc_image_bytes] on the
// device (16-byte aligned).  Returns cudaGetLastError() after the launch.
extern "C" int gcp_edge_map_tc_images(const float* weights, const int* meta, int meta_len, void* images,
                                      int dtype, void* stream) {
  Stack st;
  if (!gcp::parse_stack(meta, meta_len, st)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* img = static_cast<char*>(images);
  if (dtype == gcp::kF32) {
    edge_map_tc_images<float><<<st.n_layers, kThreads, 0, s>>>(weights, st, geometry<float>(st), img);
  } else if (dtype == gcp::kBF16) {
    edge_map_tc_images<bf16><<<st.n_layers, kThreads, 0, s>>>(weights, st, geometry<bf16>(st), img);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tile gcp_edge_map_tc launches for the layer table meta and dtype
// (gcp::DType), into out[3]: its rows (0 for a stack too wide for any), its
// weight buffers and its shared-memory bytes.  Returns 0, or -1 for a
// malformed table or dtype.
extern "C" int gcp_edge_map_tc_layout(const int* meta, int meta_len, int dtype, long long* out) {
  Stack st;
  if (!gcp::parse_stack(meta, meta_len, st)) return -1;
  Layout lay;
  if (dtype == gcp::kF32) {
    lay = layout<float>(geometry<float>(st));
  } else if (dtype == gcp::kBF16) {
    lay = layout<bf16>(geometry<bf16>(st));
  } else {
    return -1;
  }
  out[0] = lay.rows;
  out[1] = lay.nbuf;
  out[2] = static_cast<long long>(lay.smem);
  return 0;
}

// gcp_edge_map_tc_images for the same table and dtype; meta is a HOST int32
// array (edge_stack.cuh parse_stack).  Returns cudaErrorInvalidValue for a
// malformed table or dtype, cudaErrorInvalidConfiguration when the widths
// need more shared memory than a block has, else cudaGetLastError() after
// the launch (0 on success).
extern "C" int gcp_edge_map_tc(const void* msg, const void* frames, const void* images, const int* meta,
                               int meta_len, void* out, long long num_edges, int dtype, void* stream) {
  Stack st;
  if (!gcp::parse_stack(meta, meta_len, st)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == gcp::kF32) return launch<float>(msg, frames, images, st, out, num_edges, s);
  if (dtype == gcp::kBF16) return launch<bf16>(msg, frames, images, st, out, num_edges, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
