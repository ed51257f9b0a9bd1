// K2: the GCP2 message stack, fused over tiles of edge rows.
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
// act_s and act_v are the identity or relu here; the wrapper raises for any
// other setting.
//
// Bound on the H100: operations.  About 245 kFLOP per edge row against
// about 1 KB of traffic, so ~51 GFLOP and ~208 MB (bf16) per call at the
// main path's shape (208,896 edge rows, hidden 100/16, 8 layers).  The TPU
// kernel exists to keep the stack's intermediates out of device memory, and
// so does this one: a block owns kTile edge rows and keeps every layer's
// activations in shared memory in float32; it reads each input row once and
// writes each output row once.  The TPU kernel's MM-form weights
// (block-diagonal and 0/1 selector matrices, needed only because Mosaic
// cannot address single lane columns) are not carried over: the module-form
// weights are applied per x/y/z component, which does ~20% fewer operations.
// The weights (~120k values, float32) stay resident in L2 and are read
// through the read-only cache.  The matrix products run on the CUDA cores in
// float32 with register micro-tiles (RM rows x 4 columns per thread,
// 16-byte shared-memory row loads, 16-byte weight-row loads); moving them to
// the tensor cores (wgmma) is later work.  The layer body (edge_stack.cuh)
// is shared with K3.

#include "edge_stack.cuh"

namespace {

using gcp::kThreads;
using gcp::Stack;
using gcp::store_f;

constexpr int kTile = 64;  // edge rows per block

// One block per tile of kTile rows; the tile's activations (gcp::Tile) stay
// in shared memory through all the layers.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
edge_map_kernel(const T* __restrict__ msg, const T* __restrict__ frames,
                const float* __restrict__ W, const Stack st, T* __restrict__ out,
                long long num_edges) {
  extern __shared__ float4 smem4[];
  const gcp::Tile s = gcp::carve_tile<kTile>(reinterpret_cast<float*>(smem4), st);
  const long long e0 = static_cast<long long>(blockIdx.x) * kTile;
  const int rows = static_cast<int>(min(static_cast<long long>(kTile), num_edges - e0));
  const int in_dim = st.l[0].s_in + 3 * st.l[0].v_in;
  gcp::load_input<kTile>(s, st, msg + e0 * in_dim, frames + e0 * 9, rows);
  __syncthreads();
  for (int l = 0; l < st.n_layers; ++l) {
    const gcp::Layer L = st.l[l];
    gcp::layer_forward<kTile>(s, st, L, W);
    gcp::layer_output<kTile>(s, st, L, st.residual && l > 0, nullptr);
  }

  const int s_out = st.l[st.n_layers - 1].s_out, v_out = st.l[st.n_layers - 1].v_out;
  const int out_dim = s_out + 3 * v_out;
  T* dst = out + e0 * out_dim;
  for (int i = threadIdx.x; i < rows * out_dim; i += kThreads) {
    const int r = i / out_dim, col = i - r * out_dim;
    float v;
    if (col < s_out) {
      v = s.M[r * st.ldm + col];
    } else {
      const int j = col - s_out, c = j / v_out;
      v = s.X[(r * 3 + c) * st.ldx + (j - c * v_out)];
    }
    store_f(dst + i, v);
  }
}

template <typename T>
int launch(const void* msg, const void* frames, const float* weights, const Stack& st,
           void* out, long long num_edges, cudaStream_t stream) {
  const size_t smem = gcp::tile_floats<kTile>(st) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(edge_map_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (num_edges + kTile - 1) / kTile;
  edge_map_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(msg), static_cast<const T*>(frames), weights, st,
      static_cast<T*>(out), num_edges);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// message [E, s_in + 3 v_in] and frames [E, 9] (masked) in, out
// [E, s_out + 3 v_out], weights float32, all on the device; meta is a HOST
// int32 array: {n_layers, residual} then per layer {s_in, v_in, h, s_out,
// v_out, act_s, act_v, vres, vgate, off_wd, off_wso, off_bso, off_wup,
// off_wg, off_bg} (offsets in floats into weights).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int gcp_edge_map(const void* msg, const void* frames, const float* weights,
                            const int* meta, int meta_len, void* out, long long num_edges,
                            int dtype, void* stream) {
  Stack st;
  if (!gcp::parse_stack(meta, meta_len, st)) return static_cast<int>(cudaErrorInvalidValue);
  if (num_edges <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == gcp::kF32) return launch<float>(msg, frames, weights, st, out, num_edges, s);
  if (dtype == gcp::kBF16)
    return launch<__nv_bfloat16>(msg, frames, weights, st, out, num_edges, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
