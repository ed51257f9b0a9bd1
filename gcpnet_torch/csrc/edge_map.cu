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
// The weights (~155k values, float32) stay resident in L2 and are read
// through the read-only cache.  The matrix products run on the CUDA cores in
// float32 with register micro-tiles (RM rows x 4 columns per thread,
// 16-byte shared-memory row loads); moving them to the tensor cores (wgmma)
// is later work.

#include <algorithm>

#include "common.cuh"

namespace {

using gcp::to_f;
using gcp::store_f;

constexpr int kTile = 64;        // edge rows per block
constexpr int kThreads = 256;
constexpr int kMaxLayers = 16;
constexpr int kMetaHeader = 2;   // n_layers, residual
constexpr int kMetaPerLayer = 15;
constexpr int kFrameLd = 12;     // 9 frame values per row, padded
constexpr float kEps = 1e-8f;

struct Layer {
  int s_in, v_in, h, s_out, v_out;
  int act_s, act_v, vres, vgate;       // act: 0 identity, 1 relu
  int off_wd, off_wso, off_bso, off_wup, off_wg, off_bg;  // float offsets
};

struct Stack {
  int n_layers, residual;
  int ldm, ldx, ldd, lds, ldv;  // shared-memory row strides (multiples of 4)
  Layer l[kMaxLayers];
};

__device__ __forceinline__ float act(float x, int code) { return code == 1 ? fmaxf(x, 0.f) : x; }

// C[r][n] = bias[n] + sum_k act(A[r][k]) * B[k][n]  for r < R, n < N.
// A lives in shared memory with a row stride that is a multiple of 4; B is
// [K][N] row-major in global memory.  Each thread owns RM rows x 4 columns.
template <int RM>
__device__ __forceinline__ void mm(const float* A, int lda, int R, int K,
                                   const float* __restrict__ B, int N,
                                   const float* __restrict__ bias, int act_a,
                                   float* C, int ldc) {
  const int cg = (N + 3) >> 2;
  const int tiles = (R / RM) * cg;
  const int k4 = K & ~3;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const int r0 = (t / cg) * RM;
    const int n0 = (t % cg) * 4;
    const int nn = min(4, N - n0);
    float acc[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < k4; k += 4) {
      float b[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) b[kk][j] = j < nn ? __ldg(B + (k + kk) * N + n0 + j) : 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(A + (r0 + i) * lda + k);
        const float ax = act(a.x, act_a), ay = act(a.y, act_a);
        const float az = act(a.z, act_a), aw = act(a.w, act_a);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = acc[i][j];
          s = fmaf(ax, b[0][j], s);
          s = fmaf(ay, b[1][j], s);
          s = fmaf(az, b[2][j], s);
          s = fmaf(aw, b[3][j], s);
          acc[i][j] = s;
        }
      }
    }
    for (int k = k4; k < K; ++k) {
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = j < nn ? __ldg(B + k * N + n0 + j) : 0.f;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float a = act(A[(r0 + i) * lda + k], act_a);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < nn) C[(r0 + i) * ldc + n0 + j] = acc[i][j] + (bias ? __ldg(bias + n0 + j) : 0.f);
  }
}

// Shared memory, float32 (R = kTile edge rows, rows r*3 + c per component):
//   M [R][ldm]    layer input scalars, then vnorm and scal9 appended
//   X [3R][ldx]   layer input vectors, one row per component
//   D [3R][ldd]   [vh | df] per component
//   S [R][lds]    s_new
//   G [R][ldv]    gate logits
//   U [3R][ldv]   vh @ Wup per component
//   F [R][12]     frames
// The running (residual) state lives in M[:, :s_out] and X[:, :v_out].
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
edge_map_kernel(const T* __restrict__ msg, const T* __restrict__ frames,
                const float* __restrict__ W, const Stack st, T* __restrict__ out,
                long long num_edges) {
  extern __shared__ float4 smem4[];
  float* M = reinterpret_cast<float*>(smem4);
  float* X = M + kTile * st.ldm;
  float* D = X + 3 * kTile * st.ldx;
  float* S = D + 3 * kTile * st.ldd;
  float* G = S + kTile * st.lds;
  float* U = G + kTile * st.ldv;
  float* F = U + 3 * kTile * st.ldv;

  const int tid = threadIdx.x;
  const long long e0 = static_cast<long long>(blockIdx.x) * kTile;
  const int rows = static_cast<int>(min(static_cast<long long>(kTile), num_edges - e0));

  // load the tile: rows past the end are zeros (finite through the stack,
  // never stored)
  {
    const int s_in = st.l[0].s_in, v_in = st.l[0].v_in;
    const int in_dim = s_in + 3 * v_in;
    const T* src = msg + e0 * in_dim;
    for (int i = tid; i < kTile * in_dim; i += kThreads) {
      const int r = i / in_dim, col = i - r * in_dim;
      const float x = r < rows ? to_f(src[i]) : 0.f;
      if (col < s_in) {
        M[r * st.ldm + col] = x;
      } else {
        const int j = col - s_in, c = j / v_in;
        X[(r * 3 + c) * st.ldx + (j - c * v_in)] = x;
      }
    }
    const T* fsrc = frames + e0 * 9;
    for (int i = tid; i < kTile * 9; i += kThreads) {
      const int r = i / 9;
      F[r * kFrameLd + (i - r * 9)] = r < rows ? to_f(fsrc[i]) : 0.f;
    }
  }
  __syncthreads();

  for (int l = 0; l < st.n_layers; ++l) {
    const Layer L = st.l[l];
    const int h = L.h, hk = L.h + 9;
    // [vh | df] = v_c @ [Wd | Wdf] for every component row
    mm<2>(X, st.ldx, 3 * kTile, L.v_in, W + L.off_wd, h + 3, nullptr, 0, D, st.ldd);
    __syncthreads();
    // vnorm and scal9 complete the scalar_out input row
    for (int i = tid; i < kTile * hk; i += kThreads) {
      const int r = i / hk, j = i - r * hk;
      const float* d = D + r * 3 * st.ldd;
      float val;
      if (j < h) {
        const float x = d[j], y = d[st.ldd + j], z = d[2 * st.ldd + j];
        val = sqrtf(x * x + y * y + z * z + kEps) + kEps;
      } else {
        const int q = j - h, ch = q / 3, f = q - 3 * ch;
        const float* fr = F + r * kFrameLd + 3 * f;
        val = d[h + ch] * fr[0] + d[st.ldd + h + ch] * fr[1] + d[2 * st.ldd + h + ch] * fr[2];
      }
      M[r * st.ldm + L.s_in + j] = val;
    }
    __syncthreads();
    mm<8>(M, st.ldm, kTile, L.s_in + hk, W + L.off_wso, L.s_out, W + L.off_bso, 0, S, st.lds);
    mm<2>(D, st.ldd, 3 * kTile, h, W + L.off_wup, L.v_out, nullptr, 0, U, st.ldv);
    __syncthreads();
    if (L.vgate) {
      mm<2>(S, st.lds, kTile, L.s_out, W + L.off_wg, L.v_out, W + L.off_bg, L.act_v, G, st.ldv);
      __syncthreads();
    }
    // this layer's output, written over (or, for ResGCP, added to) the state
    const bool add = st.residual && l > 0;
    for (int i = tid; i < kTile * L.v_out; i += kThreads) {
      const int r = i / L.v_out, o = i - r * L.v_out;
      float u[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        u[c] = U[(r * 3 + c) * st.ldv + o] + (L.vres ? X[(r * 3 + c) * st.ldx + o] : 0.f);
      float g = 1.f;
      if (L.vgate) {
        g = 1.f / (1.f + expf(-G[r * st.ldv + o]));
      } else if (L.act_v) {
        g = act(sqrtf(u[0] * u[0] + u[1] * u[1] + u[2] * u[2] + kEps) + kEps, L.act_v);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float* x = X + (r * 3 + c) * st.ldx + o;
        *x = (add ? *x : 0.f) + u[c] * g;
      }
    }
    for (int i = tid; i < kTile * L.s_out; i += kThreads) {
      const int r = i / L.s_out, o = i - r * L.s_out;
      float* m = M + r * st.ldm + o;
      *m = (add ? *m : 0.f) + act(S[r * st.lds + o], L.act_s);
    }
    __syncthreads();
  }

  const int s_out = st.l[st.n_layers - 1].s_out, v_out = st.l[st.n_layers - 1].v_out;
  const int out_dim = s_out + 3 * v_out;
  T* dst = out + e0 * out_dim;
  for (int i = tid; i < rows * out_dim; i += kThreads) {
    const int r = i / out_dim, col = i - r * out_dim;
    float v;
    if (col < s_out) {
      v = M[r * st.ldm + col];
    } else {
      const int j = col - s_out, c = j / v_out;
      v = X[(r * 3 + c) * st.ldx + (j - c * v_out)];
    }
    store_f(dst + i, v);
  }
}

int round4(int x) { return (x + 3) & ~3; }

template <typename T>
int launch(const void* msg, const void* frames, const float* weights, const Stack& st,
           void* out, long long num_edges, cudaStream_t stream) {
  const size_t floats = static_cast<size_t>(kTile) * (st.ldm + st.lds + st.ldv + kFrameLd) +
                        static_cast<size_t>(3 * kTile) * (st.ldx + st.ldd + st.ldv);
  const size_t smem = floats * sizeof(float);
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
  if (meta_len < kMetaHeader) return static_cast<int>(cudaErrorInvalidValue);
  Stack st{};
  st.n_layers = meta[0];
  st.residual = meta[1];
  if (st.n_layers < 1 || st.n_layers > kMaxLayers ||
      meta_len != kMetaHeader + st.n_layers * kMetaPerLayer)
    return static_cast<int>(cudaErrorInvalidValue);
  int wm = 0, wx = 0, wd = 0, ws = 0, wv = 0;
  for (int l = 0; l < st.n_layers; ++l) {
    const int* m = meta + kMetaHeader + l * kMetaPerLayer;
    Layer& L = st.l[l];
    L = Layer{m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8],
              m[9], m[10], m[11], m[12], m[13], m[14]};
    if (L.v_in <= 0 || L.v_out <= 0 || L.s_out <= 0 || L.h <= 0)
      return static_cast<int>(cudaErrorInvalidValue);
    wm = std::max({wm, L.s_in + L.h + 9, L.s_out});
    wx = std::max({wx, L.v_in, L.v_out});
    wd = std::max(wd, L.h + 3);
    ws = std::max(ws, L.s_out);
    wv = std::max(wv, L.v_out);
  }
  st.ldm = round4(wm);
  st.ldx = round4(wx);
  st.ldd = round4(wd);
  st.lds = round4(ws);
  st.ldv = round4(wv);
  if (num_edges <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == gcp::kF32) return launch<float>(msg, frames, weights, st, out, num_edges, s);
  if (dtype == gcp::kBF16)
    return launch<__nv_bfloat16>(msg, frames, weights, st, out, num_edges, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
