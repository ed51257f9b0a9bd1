// The message stack's layer table, shared by every kernel of the stack
// (K2 edge_map_tc.cu and both K3s): the host passes an int32 table,
// parse_stack() turns it into a Stack passed by value to the kernel.  The
// float32 K3 (edge_map_bwd.cu) also runs its forward on the CUDA-core body
// here, with the shared-memory row strides of the Stack: layer_forward and
// layer_output run one layer on a tile of rows in shared memory.
// sum_partials adds K3's per-block weight-gradient partials (both K3s).
#pragma once

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace gcp {

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
// derivative of act at x
__device__ __forceinline__ float act_grad(float x, int code) {
  return code == 1 ? (x > 0.f ? 1.f : 0.f) : 1.f;
}

inline int round4(int x) { return (x + 3) & ~3; }

// meta: {n_layers, residual} then per layer {s_in, v_in, h, s_out, v_out,
// act_s, act_v, vres, vgate, off_wd, off_wso, off_bso, off_wup, off_wg,
// off_bg}.  Returns false on a malformed table.
inline bool parse_stack(const int* meta, int meta_len, Stack& st) {
  if (meta_len < kMetaHeader) return false;
  st = Stack{};
  st.n_layers = meta[0];
  st.residual = meta[1];
  if (st.n_layers < 1 || st.n_layers > kMaxLayers ||
      meta_len != kMetaHeader + st.n_layers * kMetaPerLayer)
    return false;
  int wm = 0, wx = 0, wd = 0, ws = 0, wv = 0;
  for (int l = 0; l < st.n_layers; ++l) {
    const int* m = meta + kMetaHeader + l * kMetaPerLayer;
    Layer& L = st.l[l];
    L = Layer{m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], m[8],
              m[9], m[10], m[11], m[12], m[13], m[14]};
    if (L.v_in <= 0 || L.v_out <= 0 || L.s_out <= 0 || L.h <= 0) return false;
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
  return true;
}

constexpr int kThreads = 256;  // threads per block of the float32 K3

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

// C[r][n] = (accumulate ? C[r][n] : 0) + bias[n] + sum_k act(A[r][k]) * B(k, n)
// for r < R, n < N, with B(k, n) = B[k * sk + n * sn]: (sk, sn) = (N, 1) reads
// a row-major [K][N] matrix, (1, K) the transpose of a row-major [N][K] one.
// A lives in shared memory with a row stride that is a multiple of 4.  Each
// thread owns RM rows x 4 columns; B's rows are read as 16-byte vectors when
// sn == 1 and they are 16-byte aligned (pack_stack aligns every matrix).
template <int RM>
__device__ __forceinline__ void mm(const float* A, int lda, int R, int K,
                                   const float* __restrict__ B, int sk, int sn, int N,
                                   const float* __restrict__ bias, int act_a,
                                   float* C, int ldc, bool accumulate) {
  const int cg = (N + 3) >> 2;
  const int tiles = (R / RM) * cg;
  const int k4 = K & ~3;
  // rows of B as 16-byte loads where they are contiguous and aligned
  const bool b_vec = sn == 1 && (sk & 3) == 0 && (reinterpret_cast<uintptr_t>(B) & 15) == 0;
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
      if (b_vec && nn == 4) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(B + (k + kk) * sk + n0));
          b[kk][0] = v.x;
          b[kk][1] = v.y;
          b[kk][2] = v.z;
          b[kk][3] = v.w;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            b[kk][j] = j < nn ? __ldg(B + (k + kk) * sk + (n0 + j) * sn) : 0.f;
      }
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
      for (int j = 0; j < 4; ++j) b[j] = j < nn ? __ldg(B + k * sk + (n0 + j) * sn) : 0.f;
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
        if (j < nn) {
          float* c = C + (r0 + i) * ldc + n0 + j;
          *c = (accumulate ? *c : 0.f) + acc[i][j] + (bias ? __ldg(bias + n0 + j) : 0.f);
        }
  }
}

// A tile of R edge rows' forward activations in shared memory, float32
// (rows r*3 + c per vector component c):
//   M [R][ldm]    layer input scalars, then vnorm and scal9 appended
//   X [3R][ldx]   layer input vectors
//   D [3R][ldd]   [vh | df]
//   S [R][lds]    s_new
//   G [R][ldv]    gate logits
//   U [3R][ldv]   vh @ Wup
//   F [R][12]     frames
// The running (residual) state lives in M[:, :s_out] and X[:, :v_out].
struct Tile {
  float *M, *X, *D, *S, *G, *U, *F;
};

template <int R>
__host__ __device__ inline size_t tile_floats(const Stack& st) {
  return static_cast<size_t>(R) * (st.ldm + st.lds + st.ldv + kFrameLd) +
         static_cast<size_t>(3 * R) * (st.ldx + st.ldd + st.ldv);
}

template <int R>
__device__ inline Tile carve_tile(float* base, const Stack& st) {
  Tile t;
  t.M = base;
  t.X = t.M + R * st.ldm;
  t.D = t.X + 3 * R * st.ldx;
  t.S = t.D + 3 * R * st.ldd;
  t.G = t.S + R * st.lds;
  t.U = t.G + R * st.ldv;
  t.F = t.U + 3 * R * st.ldv;
  return t;
}

// The stack's input rows and their frames into the tile; rows past the end
// are zeros (finite through the stack, never stored).
template <int R, typename T>
__device__ void load_input(const Tile& s, const Stack& st, const T* __restrict__ msg,
                           const T* __restrict__ frames, int rows) {
  const Layer L = st.l[0];
  const int in_dim = L.s_in + 3 * L.v_in;
  for (int i = threadIdx.x; i < R * in_dim; i += kThreads) {
    const int r = i / in_dim, col = i - r * in_dim;
    const float x = r < rows ? to_f(msg[i]) : 0.f;
    if (col < L.s_in) {
      s.M[r * st.ldm + col] = x;
    } else {
      const int j = col - L.s_in, c = j / L.v_in;
      s.X[(r * 3 + c) * st.ldx + (j - c * L.v_in)] = x;
    }
  }
  for (int i = threadIdx.x; i < R * 9; i += kThreads) {
    const int r = i / 9;
    s.F[r * kFrameLd + (i - r * 9)] = r < rows ? to_f(frames[i]) : 0.f;
  }
}

// Layer l's intermediates D, M[:, s_in:], S, U and G from its input state
// in M[:, :s_in] and X.
template <int R>
__device__ void layer_forward(const Tile& s, const Stack& st, const Layer& L,
                              const float* __restrict__ W) {
  const int tid = threadIdx.x;
  const int h = L.h, hk = L.h + 9;
  mm<2>(s.X, st.ldx, 3 * R, L.v_in, W + L.off_wd, h + 3, 1, h + 3, nullptr, 0, s.D, st.ldd, false);
  __syncthreads();
  for (int i = tid; i < R * hk; i += kThreads) {
    const int r = i / hk, j = i - r * hk;
    const float* d = s.D + r * 3 * st.ldd;
    float val;
    if (j < h) {
      const float x = d[j], y = d[st.ldd + j], z = d[2 * st.ldd + j];
      val = sqrtf(x * x + y * y + z * z + kEps) + kEps;
    } else {
      const int q = j - h, ch = q / 3, f = q - 3 * ch;
      const float* fr = s.F + r * kFrameLd + 3 * f;
      val = d[h + ch] * fr[0] + d[st.ldd + h + ch] * fr[1] + d[2 * st.ldd + h + ch] * fr[2];
    }
    s.M[r * st.ldm + L.s_in + j] = val;
  }
  __syncthreads();
  constexpr int RM = R % 8 == 0 ? 8 : 6;  // rows a thread for the R-row products
  mm<RM>(s.M, st.ldm, R, L.s_in + hk, W + L.off_wso, L.s_out, 1, L.s_out, W + L.off_bso, 0, s.S,
         st.lds, false);
  mm<2>(s.D, st.ldd, 3 * R, h, W + L.off_wup, L.v_out, 1, L.v_out, nullptr, 0, s.U, st.ldv, false);
  __syncthreads();
  if (L.vgate) {
    mm<2>(s.S, st.lds, R, L.s_out, W + L.off_wg, L.v_out, 1, L.v_out, W + L.off_bg, L.act_v,
          s.G, st.ldv, false);
    __syncthreads();
  }
}

// Layer l's output written over (ResGCP: added to) the state and, unless
// slot is null, copied to slot ([R][s_out] scalars, then [3R][v_out]).
template <int R>
__device__ void layer_output(const Tile& s, const Stack& st, const Layer& L, bool add, float* slot) {
  const int tid = threadIdx.x;
  float* slot_v = slot ? slot + R * L.s_out : nullptr;
  for (int i = tid; i < R * L.v_out; i += kThreads) {
    const int r = i / L.v_out, o = i - r * L.v_out;
    float u[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      u[c] = s.U[(r * 3 + c) * st.ldv + o] + (L.vres ? s.X[(r * 3 + c) * st.ldx + o] : 0.f);
    float g = 1.f;
    if (L.vgate) {
      g = 1.f / (1.f + expf(-s.G[r * st.ldv + o]));
    } else if (L.act_v) {
      g = act(sqrtf(u[0] * u[0] + u[1] * u[1] + u[2] * u[2] + kEps) + kEps, L.act_v);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float* x = s.X + (r * 3 + c) * st.ldx + o;
      *x = (add ? *x : 0.f) + u[c] * g;
      if (slot) slot_v[(r * 3 + c) * L.v_out + o] = *x;
    }
  }
  for (int i = tid; i < R * L.s_out; i += kThreads) {
    const int r = i / L.s_out, o = i - r * L.s_out;
    float* m = s.M + r * st.ldm + o;
    *m = (add ? *m : 0.f) + act(s.S[r * st.lds + o], L.act_s);
    if (slot) slot[r * L.s_out + o] = *m;
  }
  __syncthreads();
}

}  // namespace gcp
