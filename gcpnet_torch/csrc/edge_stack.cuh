// The message stack's layer table, shared by every kernel of the stack
// (K2 edge_map_tc.cu and K3 edge_map_bwd_tc.cu): the host passes an int32
// table, parse_stack() turns it into a Stack passed by value to the
// kernel.  sum_partials adds K3's per-block weight-gradient partials.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace gcp {

constexpr int kMaxLayers = 16;
constexpr int kMetaHeader = 2;   // n_layers, residual
constexpr int kMetaPerLayer = 15;
constexpr int kSlopesPerLayer = 1;  // after every layer's words: its leaky slope, float32 bits
constexpr int kFrameLd = 12;     // 9 frame values per row, padded
constexpr float kEps = 1e-8f;

struct Layer {
  int s_in, v_in, h, s_out, v_out;
  int act_s, act_v, vres, vgate;       // act: 0 identity, 1 relu, 2 leaky relu, 3 silu
  int off_wd, off_wso, off_bso, off_wup, off_wg, off_bg;  // float offsets
  float slope;                         // leaky relu's slope below 0
};

struct Stack {
  int n_layers, residual;
  Layer l[kMaxLayers];
};

constexpr int kActCodes = 4;  // 0 identity, 1 relu, 2 leaky relu, 3 silu

// k2_breakdown.py builds K2 (edge_map_tc.cu) with K2_CUT set to one of the
// K2Cut values below, each removing one part of the forward's work (the
// results are then wrong); K3 never sets it.
#ifndef K2_CUT
#define K2_CUT 0
#endif

enum K2Cut {
  kK2Whole = 0,
  kK2NoProducts = 1,       // no X Wd, vh Wup, M Wso, act(S) Wg
  kK2NoElementwise = 2,    // no vnorm / scal9 pass and no layer output pass
  kK2NoWeightStaging = 3,  // no copy of the layers' weights into shared memory
  kK2BarriersOnly = 4,     // none of the three: the tile's input, output and barriers
  kK2NoInputOutput = 5     // no tile input loaded, no output stored
};
constexpr int kK2Cut = K2_CUT;
constexpr bool kK2Products = kK2Cut != kK2NoProducts && kK2Cut != kK2BarriersOnly;
constexpr bool kK2Elementwise = kK2Cut != kK2NoElementwise && kK2Cut != kK2BarriersOnly;
constexpr bool kK2Staging = kK2Cut != kK2NoWeightStaging && kK2Cut != kK2BarriersOnly;
constexpr bool kK2InputOutput = kK2Cut != kK2NoInputOutput;

// max(x, 0), and a NaN for a NaN x (fmaxf would give 0), as torch.relu and
// jax.nn.relu do
__device__ __forceinline__ float relu(float x) {
  float y;
  asm("max.NaN.f32 %0, %1, 0f00000000;\n" : "=f"(y) : "f"(x));
  return y;
}
// x where x >= 0, else slope x: jax.nn.leaky_relu's where(x >= 0, ...), so
// a NaN gives slope * NaN, a NaN
__device__ __forceinline__ float leaky_relu(float x, float slope) { return x >= 0.f ? x : slope * x; }
// 1 / (1 + exp(-x)), as the vector gate takes it
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
// x sigmoid(x), as jax.nn.silu computes it: -0 far below 0, a NaN for a NaN
__device__ __forceinline__ float silu(float x) { return x * sigmoid(x); }
// the activation of code kAct (0 identity, 1 relu, 2 leaky relu, 3 silu)
// for a code known at compile time (the hot loops take one copy per code)
template <int kAct>
__device__ __forceinline__ float act(float x, float slope) {
  if constexpr (kAct == 1) return relu(x);
  if constexpr (kAct == 2) return leaky_relu(x, slope);
  if constexpr (kAct == 3) return silu(x);
  return x;
}
// the activation of a code known at run time; silu only in a kernel built
// for stacks that use it (kSilu), so that the others compile as before
template <bool kSilu>
__device__ __forceinline__ float act(float x, int code, float slope) {
  if constexpr (kSilu) {
    if (code == 3) return act<3>(x, slope);
  }
  return code == 1 ? act<1>(x, slope) : code == 2 ? act<2>(x, slope) : x;
}

// The derivative of an activation of code 0-2 as its values below 0 and at
// 0 (above 0 it is 1): relu 0 and 0, leaky relu the slope and 1 (x >= 0,
// as jax.grad gives it), the identity 1 and 1.  Made once a layer, so that
// the loops that apply it test no code; a NaN takes the value below 0, as
// JAX's where(x > 0, ...) and where(x >= 0, ...) do.
struct ActGrad {
  float below, at;
  __device__ __forceinline__ ActGrad(int code, float slope)
      : below(code == 1 ? 0.f : code == 2 ? slope : 1.f), at(code == 1 ? 0.f : 1.f) {}
  __device__ __forceinline__ float operator()(float x) const { return x > 0.f ? 1.f : x >= 0.f ? at : below; }
};

// silu's derivative s + x s (1 - s), s = sigmoid(x), as jax.grad of
// x sigmoid(x) gives it (a NaN for a NaN).
struct SiluGrad {
  __device__ __forceinline__ float operator()(float x) const {
    const float s = sigmoid(x);
    return s + x * s * (1.f - s);
  }
};

// fn(the derivative of the activation of code): SiluGrad for silu (3) in a
// kernel built for stacks that use it (kSilu), else ActGrad.  The loops
// inside fn apply it with no test of the code per element.
template <bool kSilu, typename Fn>
__device__ __forceinline__ void with_act_grad(int code, float slope, Fn&& fn) {
  if constexpr (kSilu) {
    if (code == 3) {
      fn(SiluGrad{});
      return;
    }
  }
  fn(ActGrad(code, slope));
}

// Whether any layer of st applies silu: its kernels are the kSilu
// instantiations, which alone carry silu's code (a stack without silu runs
// the same code as before silu joined the table, at its register use).
inline bool uses_silu(const Stack& st) {
  for (int l = 0; l < st.n_layers; ++l)
    if (st.l[l].act_s == 3 || st.l[l].act_v == 3) return true;
  return false;
}

// meta: {n_layers, residual}, then per layer {s_in, v_in, h, s_out, v_out,
// act_s, act_v, vres, vgate, off_wd, off_wso, off_bso, off_wup, off_wg,
// off_bg}, then per layer its slope (float32 bits).  Returns false on a
// malformed table.
inline bool parse_stack(const int* meta, int meta_len, Stack& st) {
  if (meta_len < kMetaHeader) return false;
  st = Stack{};
  st.n_layers = meta[0];
  st.residual = meta[1];
  if (st.n_layers < 1 || st.n_layers > kMaxLayers ||
      meta_len != kMetaHeader + st.n_layers * (kMetaPerLayer + kSlopesPerLayer))
    return false;
  const int* slopes = meta + kMetaHeader + st.n_layers * kMetaPerLayer;
  for (int l = 0; l < st.n_layers; ++l) {
    const int* m = meta + kMetaHeader + l * kMetaPerLayer;
    Layer& L = st.l[l];
    L = Layer{m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8],
              m[9], m[10], m[11], m[12], m[13], m[14], 0.f};
    std::memcpy(&L.slope, slopes + l, sizeof(float));
    if (L.v_in <= 0 || L.v_out <= 0 || L.s_out <= 0 || L.h <= 0) return false;
    if (L.act_s < 0 || L.act_s >= kActCodes || L.act_v < 0 || L.act_v >= kActCodes) return false;
  }
  return true;
}

// K3's weight gradients from its blocks' float32 partials: out[i] = sum over
// blocks b, in order, of partials[b * w_len + i] (a fixed order, so the same
// result from run to run).
__global__ void sum_partials(const float* __restrict__ partials, int blocks, long long w_len,
                             float* __restrict__ out) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < w_len;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float sum = 0.f;
    for (int b = 0; b < blocks; ++b) sum += partials[b * w_len + i];
    out[i] = sum;
  }
}

// Launches sum_partials; returns cudaGetLastError() after it.
inline int launch_sum_partials(const float* partials, int blocks, long long w_len, float* out,
                               cudaStream_t stream) {
  constexpr int kReduceThreads = 256;
  const long long grid = std::min<long long>((w_len + kReduceThreads - 1) / kReduceThreads, 1024);
  sum_partials<<<static_cast<unsigned>(grid), kReduceThreads, 0, stream>>>(partials, blocks, w_len, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gcp
