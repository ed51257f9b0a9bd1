// The message stack's layer table, shared by every kernel of the stack
// (K2 edge_map_tc.cu and K3 edge_map_bwd_tc.cu): the host passes an int32
// table, parse_stack() turns it into a Stack passed by value to the
// kernel.  sum_partials adds K3's per-block weight-gradient partials.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace gcp {

constexpr int kMaxLayers = 32;  // 8 + 32 x 64 bytes of Stack: under a launch's 4 KB of parameters
constexpr int kMetaHeader = 2;   // n_layers, residual
constexpr int kMetaPerLayer = 15;
constexpr int kSlopesPerLayer = 1;  // after every layer's words: its leaky slope, float32 bits
constexpr int kFrameLd = 12;     // 9 frame values per row, padded
constexpr float kEps = 1e-8f;

struct Layer {
  int s_in, v_in, h, s_out, v_out;
  int act_s, act_v, vres, vgate;       // act: an ActCode
  int off_wd, off_wso, off_bso, off_wup, off_wg, off_bg;  // float offsets
  float slope;                         // leaky relu's slope below 0
};

struct Stack {
  int n_layers, residual;
  Layer l[kMaxLayers];
};

// The layer table's activation codes.  The kernels are built for the codes
// below a bound kCodes, each a template argument: kActSilu (identity, relu
// and leaky relu, the code they ran before the transcendental codes joined
// the table), kActSelu (silu too: AR's, as before selu, gelu, sigmoid and
// tanh joined) and kActCodes (every code: stacks with one of those four).
// stack_codes gives a stack's bound.  The kActCodes builds resolve each of
// those four codes once a layer, each into a copy of the code of its own
// (with_act_code, with_act_grad), and run codes 0-3 as the kActSelu builds
// do.
enum ActCode : int {
  kActIdentity = 0,
  kActRelu = 1,
  kActLeaky = 2,
  kActSilu = 3,
  kActSelu = 4,
  kActGelu = 5,
  kActSigmoid = 6,
  kActTanh = 7
};
constexpr int kActCodes = 8;

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
// jax.nn.selu's constants, and selu as it computes it: scale x above 0,
// else scale alpha expm1(x) (a NaN for a NaN)
constexpr float kSeluAlpha = 1.6732632423543772848170429916717f;
constexpr float kSeluScale = 1.0507009873554804934193349852946f;
__device__ __forceinline__ float selu(float x) { return kSeluScale * (x > 0.f ? x : kSeluAlpha * expm1f(x)); }
// jax.nn.gelu's default tanh form: x 0.5 (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3)))
constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluK = 0.044715f;
__device__ __forceinline__ float gelu(float x) {
  return x * (0.5f * (1.f + tanhf(kGeluC * (x + kGeluK * (x * x * x)))));
}
// the activation of code kAct, known at compile time (the hot loops take
// one copy per code)
template <int kAct>
__device__ __forceinline__ float act(float x, float slope) {
  if constexpr (kAct == kActRelu) return relu(x);
  if constexpr (kAct == kActLeaky) return leaky_relu(x, slope);
  if constexpr (kAct == kActSilu) return silu(x);
  if constexpr (kAct == kActSelu) return selu(x);
  if constexpr (kAct == kActGelu) return gelu(x);
  if constexpr (kAct == kActSigmoid) return sigmoid(x);
  if constexpr (kAct == kActTanh) return tanhf(x);
  return x;
}
// the activation of a code 0-3 known at run time, below kCodes (kActSilu:
// relu and leaky relu; kActSelu: silu too), so that a kernel carries only
// the codes it is built for
template <int kCodes>
__device__ __forceinline__ float act_of_code(float x, int code, float slope) {
  if constexpr (kCodes > kActSilu) {
    if (code == kActSilu) return act<kActSilu>(x, slope);
  }
  return code == kActRelu ? act<kActRelu>(x, slope) : code == kActLeaky ? act<kActLeaky>(x, slope) : x;
}

// A code read at run time, 0-3 (with_act_code).
constexpr int kActAtRunTime = -1;

// act<kAct>, or for kAct = kActAtRunTime the activation of code, 0-3, as
// the kActSelu builds take it
template <int kAct>
__device__ __forceinline__ float act_of(float x, int code, float slope) {
  if constexpr (kAct == kActAtRunTime) {
    return act_of_code<kActSelu>(x, code, slope);
  } else {
    return act<kAct>(x, slope);
  }
}

// fn(std::integral_constant<int, code>) for code selu, gelu, sigmoid or
// tanh in a build for every code (kCodes = kActCodes), else
// fn(std::integral_constant<int, kActAtRunTime>): codes 0-3, read at run
// time as before those four joined the table.  Resolved once a layer, so
// that the products and loops inside fn test no code per element for them.
template <int kCodes, typename Fn>
__device__ __forceinline__ void with_act_code(int code, Fn&& fn) {
  if constexpr (kCodes > kActSelu) {
    switch (code) {
      case kActSelu: fn(std::integral_constant<int, kActSelu>{}); return;
      case kActGelu: fn(std::integral_constant<int, kActGelu>{}); return;
      case kActSigmoid: fn(std::integral_constant<int, kActSigmoid>{}); return;
      case kActTanh: fn(std::integral_constant<int, kActTanh>{}); return;
      default: break;
    }
  }
  fn(std::integral_constant<int, kActAtRunTime>{});
}

// The derivative of an activation of code 0-2 as its values below 0 and at
// 0 (above 0 it is 1): relu 0 and 0, leaky relu the slope and 1 (x >= 0,
// as jax.grad gives it), the identity 1 and 1.  Made once a layer, so that
// the loops that apply it test no code; a NaN takes the value below 0, as
// JAX's where(x > 0, ...) and where(x >= 0, ...) do.
struct ActGrad {
  static constexpr int kCode = kActAtRunTime;  // its activation (act_of)
  float below, at;
  __device__ __forceinline__ ActGrad(int code, float slope)
      : below(code == kActRelu ? 0.f : code == kActLeaky ? slope : 1.f), at(code == kActRelu ? 0.f : 1.f) {}
  __device__ __forceinline__ float operator()(float x) const { return x > 0.f ? 1.f : x >= 0.f ? at : below; }
};

// The transcendental activations' derivatives, in float32, as jax.grad
// gives them; each is a NaN for a NaN.
// silu: s + x s (1 - s), s = sigmoid(x)
struct SiluGrad {
  static constexpr int kCode = kActSilu;
  __device__ __forceinline__ float operator()(float x) const {
    const float s = sigmoid(x);
    return s + x * s * (1.f - s);
  }
};
// selu: scale above 0, scale alpha exp(x) at and below it (1.7581 at 0:
// JAX's where(x > 0, ...) takes 0 below)
struct SeluGrad {
  static constexpr int kCode = kActSelu;
  __device__ __forceinline__ float operator()(float x) const {
    return x > 0.f ? kSeluScale : kSeluScale * kSeluAlpha * expf(x);
  }
};
// gelu's tanh form: 0.5 (1 + t) + 0.5 x (1 - t^2) sqrt(2 / pi) (1 + 3 k x^2),
// t = tanh(sqrt(2 / pi) (x + k x^3))
struct GeluGrad {
  static constexpr int kCode = kActGelu;
  __device__ __forceinline__ float operator()(float x) const {
    const float x2 = x * x;
    const float t = tanhf(kGeluC * (x + kGeluK * (x2 * x)));
    return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * kGeluC * (1.f + 3.f * kGeluK * x2);
  }
};
// sigmoid: s (1 - s)
struct SigmoidGrad {
  static constexpr int kCode = kActSigmoid;
  __device__ __forceinline__ float operator()(float x) const {
    const float s = sigmoid(x);
    return s * (1.f - s);
  }
};
// tanh: 1 - t^2
struct TanhGrad {
  static constexpr int kCode = kActTanh;
  __device__ __forceinline__ float operator()(float x) const {
    const float t = tanhf(x);
    return 1.f - t * t;
  }
};

// fn(the derivative of the activation of code), for a code below kCodes
// (kActSilu: 0-2, relu and leaky relu; kActSelu: 0-3, silu too; kActCodes:
// every code): ActGrad for 0-2, else the code's functor.  Made once a layer,
// so that the loops inside fn apply it with no test of the code per element;
// the code carries one copy of fn for each functor below kCodes.
template <int kCodes, typename Fn>
__device__ __forceinline__ void with_act_grad(int code, float slope, Fn&& fn) {
  if constexpr (kCodes > kActSelu) {
    switch (code) {
      case kActSelu: fn(SeluGrad{}); return;
      case kActGelu: fn(GeluGrad{}); return;
      case kActSigmoid: fn(SigmoidGrad{}); return;
      case kActTanh: fn(TanhGrad{}); return;
      default: break;
    }
  }
  if constexpr (kCodes > kActSilu) {
    if (code == kActSilu) {
      fn(SiluGrad{});
      return;
    }
  }
  fn(ActGrad(code, slope));
}

// The bound of st's activation codes (see ActCode): kActSilu where every
// layer applies the identity, relu or leaky relu, kActSelu where silu is
// the largest code, else kActCodes.
inline int stack_codes(const Stack& st) {
  int top = kActIdentity;
  for (int l = 0; l < st.n_layers; ++l) top = std::max({top, st.l[l].act_s, st.l[l].act_v});
  return top < kActSilu ? kActSilu : top == kActSilu ? kActSelu : kActCodes;
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
