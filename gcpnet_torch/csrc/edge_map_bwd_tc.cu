// K3 in bf16: the backward of the fused GCP2 message stack (K2) on the
// tensor cores, recomputing the stack's forward per tile of edge rows.
//
//   d_msg[e, :] = d_out[e, :] . d stack(msg[e, :], frames[e, :]) / d msg
//   d_W         = sum over e of d_out[e, :] . d stack(msg[e, :], frames[e, :]) / d W
//
// Replaces, for bf16 activations, the TPU kernel of
// gcpnet_tpu/ops/pallas_fused.py (_map_bwd, pallas_call at :175), which per
// block of rows re-runs the stack under jax.vjp in bf16 with float32
// accumulators, writes d edge_data in bf16 and accumulates the weight
// gradients in float32.  The float32 path keeps edge_map_bwd.cu.  The
// frames get no gradient (in LBA they depend on no parameter).  The layer
// math and its backward are edge_map_bwd.cu's (:13-22); the arithmetic is
// edge_stack_mma.cuh's: every product on bf16 operands with float32
// accumulators, on the tensor cores.
//
// Bound on the H100: operations.  Recompute plus backward is about three
// times the forward's 245 kFLOP per edge row: ~153 GFLOP per call at the
// main path's shape (208,896 rows, 8 layers, hidden 100/16), 0.155 ms at the
// bf16 tensor-core peak, against ~350 MB of inputs and outputs (0.105 ms).
//
// Design:
// - Tile of 64 rows, 512 threads, one block per SM.  The tile's bf16
//   activations, one layer's weights staged as bf16 (layer 0's Wso is the
//   largest, [256][104]), the float32 cotangents of the state and the bf16
//   cotangents that feed products take ~220 KB of the 227 KB a block may use
//   at the main path's widths.
// - Every product is a warp-level mma.sync m16n8k16 fed by ldmatrix
//   (gcp::tc::gemm): the forward's X Wd, M Wso, vh Wup, act(S) Wg; the
//   backward's dG Wg^T, dS Wso^T, dU Wup^T, dD Wd^T, which read the staged
//   weights transposed through ldmatrix, so no transposed copy exists; and
//   the weight gradients A^T G, whose reduction runs over the tile's rows
//   (A read transposed with ldmatrix.trans).
// - Between the sweeps only each layer's input state is kept, in bf16, in a
//   per-block scratch in global memory (148 values a row per layer at the
//   main path's widths, ~132 KB per block); the reverse sweep recomputes a
//   layer's intermediates from it on the tensor cores before its backward.
// - Weight gradients, deterministically and without float atomics: a
//   persistent grid (one block per SM) walks the tiles in a fixed order;
//   each block owns a float32 partial of all weights in global memory, whose
//   values are the starting accumulators of each tile's weight-gradient
//   products and are stored back after them; a second kernel sums the
//   partials in block order.
// - The cotangent of layer 0's input goes from the products' epilogues
//   straight to d msg.
//
// k3_breakdown.py builds this file with K3_CUT set to one of the Cut values
// below, each removing one part of the work (the results are then wrong),
// and times the variants.

#include <cstdint>

#include "edge_stack_mma.cuh"

#ifndef K3_CUT
#define K3_CUT 0
#endif

namespace {

using gcp::act;
using gcp::act_grad;
using gcp::kEps;
using gcp::kFrameLd;
using gcp::Layer;
using gcp::Stack;
using namespace gcp::tc;

enum Cut {
  kWhole = 0,
  kNoPartials = 1,        // weight-gradient products start at 0 and are not stored
  kNoWeightGrads = 2,     // no weight-gradient products or bias sums
  kNoScratch = 3,         // no input state written to or read from the scratch
  kNoForwardSweep = 4,    // the forward sweep runs the last layer only
  kNoRecompute = 5,       // the reverse sweep recomputes no layer
  kNoBackwardProducts = 6 // no dG Wg^T, dS Wso^T, dU Wup^T, dD Wd^T
};
constexpr int kCut = K3_CUT;
constexpr int R = kTile;

// P[m * N + n] += sum over rows r < rows_red of A(r, m) G(r, n), for m < M,
// n < N: one tile's contribution to a weight gradient, added to the block's
// float32 partial (no other block writes it).  A [rows_red][lda] and
// G [rows_red][ldg] are bf16 tile arrays; relu_a applies relu to A.
__device__ __forceinline__ void wgrad(const bf16* A, int lda, int M, bool relu_a, const bf16* G,
                                      int ldg, int N, int rows_red, float* P) {
  if constexpr (kCut == kNoWeightGrads) return;
  gemm<bf16, true, false>(
      A, lda, G, ldg, pad16(M), pad8(N), rows_red, relu_a,
      [&](int m, int n, float& v0, float& v1) {
        const bool ok = kCut != kNoPartials && m < M;
        v0 = ok && n < N ? P[m * N + n] : 0.f;
        v1 = ok && n + 1 < N ? P[m * N + n + 1] : 0.f;
      },
      [&](int m, int n, float v0, float v1) {
        if (kCut == kNoPartials || m >= M) return;
        if (n < N) P[m * N + n] = v0;
        if (n + 1 < N) P[m * N + n + 1] = v1;
      });
}

// P[n] += sum over the tile's rows of G[r][n], n < N (a bias gradient)
__device__ __forceinline__ void bias_grad(const bf16* G, int ldg, int N, float* P) {
  if constexpr (kCut == kNoWeightGrads) return;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < R; ++r) sum += f(G[r * ldg + n]);
    if (kCut != kNoPartials) P[n] += sum;
  }
}

// Layer L's backward: from the cotangent (dY, dV) of its output and its
// intermediates in the tile, the weight gradients (added to P) and the
// cotangent of its input: into dY and dV (added to the output's, when
// pass_through: ResGCP), or, for layer 0 (dmsg != nullptr), into d msg's
// rows.
__device__ void layer_backward(const Smem<bf16>& s, const Geom& g, const Layer& L, float* P,
                               bool pass_through, bf16* dmsg, int rows) {
  const int tid = threadIdx.x;
  const int h = L.h, hk = h + 9, K = L.s_in + hk;
  const int in_dim = L.s_in + 3 * L.v_in;
  // the gates, elementwise: dG over G, dU over U
  for (int i = tid; i < R * L.v_out; i += kThreads) {
    const int r = i / L.v_out, o = i - r * L.v_out;
    float u[3], dv[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      u[c] = f(s.U[(r * 3 + c) * g.ldv + o]) + (L.vres ? f(s.X[(r * 3 + c) * g.ldx + o]) : 0.f);
      dv[c] = s.dV[(r * 3 + c) * g.ldvf + o];
    }
    const float dg = dv[0] * u[0] + dv[1] * u[1] + dv[2] * u[2];
    float du[3];
    if (L.vgate) {
      const float gt = 1.f / (1.f + expf(-f(s.G[r * g.ldv + o])));
      s.G[r * g.ldv + o] = __float2bfloat16_rn(dg * gt * (1.f - gt));
#pragma unroll
      for (int c = 0; c < 3; ++c) du[c] = dv[c] * gt;
    } else if (L.act_v) {
      const float rt = sqrtf(u[0] * u[0] + u[1] * u[1] + u[2] * u[2] + kEps);
      const float n = rt + kEps;
      const float gt = act(n, L.act_v);
      const float dn = dg * act_grad(n, L.act_v) / rt;
#pragma unroll
      for (int c = 0; c < 3; ++c) du[c] = dv[c] * gt + dn * u[c];
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) du[c] = dv[c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) s.U[(r * 3 + c) * g.ldv + o] = __float2bfloat16_rn(du[c]);
  }
  if (!L.vgate) {
    for (int i = tid; i < R * L.s_out; i += kThreads) {
      const int r = i / L.s_out, o = i - r * L.s_out;
      s.dS[r * g.lds + o] =
          __float2bfloat16_rn(s.dY[r * g.ldy + o] * act_grad(f(s.S[r * g.lds + o]), L.act_s));
    }
  }
  __syncthreads();
  const bf16* dG = s.G;
  const bf16* dU = s.U;
  if (L.vgate) {
    // dS = dY act_s'(S) + (dG Wg^T) act_v'(S);  dWg += act_v(S)^T dG;  dbg
    if constexpr (kCut != kNoBackwardProducts) {
      gemm<bf16, false, true>(dG, g.ldv, s.wg, g.ld_wg, R, pad8(L.s_out), pad16(L.v_out), false, ZeroInit{},
                        [&](int m, int n, float v0, float v1) {
                          const float v[2] = {v0, v1};
#pragma unroll
                          for (int j = 0; j < 2; ++j) {
                            if (n + j >= L.s_out) break;
                            const float sv = f(s.S[m * g.lds + n + j]);
                            s.dS[m * g.lds + n + j] = __float2bfloat16_rn(
                                s.dY[m * g.ldy + n + j] * act_grad(sv, L.act_s) + v[j] * act_grad(sv, L.act_v));
                          }
                        });
    }
    wgrad(s.S, g.lds, L.s_out, L.act_v == 1, dG, g.ldv, L.v_out, R, P + L.off_wg);
    bias_grad(dG, g.ldv, L.v_out, P + L.off_bg);
    __syncthreads();
  }
  // dM = dS Wso^T: its first s_in columns into dY (or d msg), the rest
  // (vnorm's and scal9's) into dMs;  dWso += M^T dS;  dbso
  if constexpr (kCut != kNoBackwardProducts) {
    gemm<bf16, false, true>(s.dS, g.lds, s.wso, g.ld_wso, R, pad8(K), pad16(L.s_out), false, ZeroInit{},
                      [&](int m, int n, float v0, float v1) {
                        const float v[2] = {v0, v1};
#pragma unroll
                        for (int j = 0; j < 2; ++j) {
                          const int col = n + j;
                          if (col >= K) break;
                          if (col >= L.s_in) {
                            s.dMs[m * g.ldms + col - L.s_in] = v[j];
                          } else if (dmsg) {
                            if (m < rows) dmsg[m * in_dim + col] = __float2bfloat16_rn(v[j]);
                          } else {
                            float* y = s.dY + m * g.ldy + col;
                            *y = (pass_through ? *y : 0.f) + v[j];
                          }
                        }
                      });
  }
  wgrad(s.M, g.ldm, K, false, s.dS, g.lds, L.s_out, R, P + L.off_wso);
  bias_grad(s.dS, g.lds, L.s_out, P + L.off_bso);
  __syncthreads();
  // dD[:, :h] = dU Wup^T + the vnorm's part;  dD[:, h:] from scal9's;  dWup += vh^T dU
  if constexpr (kCut != kNoBackwardProducts) {
    gemm<bf16, false, true>(dU, g.ldv, s.wup, g.ld_wup, 3 * R, pad8(h), pad16(L.v_out), false, ZeroInit{},
                      [&](int m, int n, float v0, float v1) {
                        const float v[2] = {v0, v1};
                        const int r = m / 3;
                        const bf16* d = s.D + r * 3 * g.ldd;
#pragma unroll
                        for (int j = 0; j < 2; ++j) {
                          const int col = n + j;
                          if (col >= h) break;
                          const float x = f(d[col]), y = f(d[g.ldd + col]), z = f(d[2 * g.ldd + col]);
                          const float fac = s.dMs[r * g.ldms + col] / sqrtf(x * x + y * y + z * z + kEps);
                          s.dD[m * g.ldd + col] = __float2bfloat16_rn(v[j] + fac * f(s.D[m * g.ldd + col]));
                        }
                      });
  }
  for (int i = tid; i < R * 9; i += kThreads) {
    const int r = i / 9, q = i - r * 9, ch = q / 3, a = q - 3 * ch;
    const float* dm = s.dMs + r * g.ldms + h + ch * 3;
    const float* fr = s.F + r * kFrameLd + a;
    s.dD[(r * 3 + a) * g.ldd + h + ch] = __float2bfloat16_rn(dm[0] * fr[0] + dm[1] * fr[3] + dm[2] * fr[6]);
  }
  wgrad(s.D, g.ldd, h, false, dU, g.ldv, L.v_out, 3 * R, P + L.off_wup);
  __syncthreads();
  // dV (+)= [dvh | ddf] [Wd | Wdf]^T (+ dU with the vector residual), or d
  // msg's vectors;  d[Wd | Wdf] += X^T [dvh | ddf]
  if constexpr (kCut != kNoBackwardProducts) {
    gemm<bf16, false, true>(s.dD, g.ldd, s.wd, g.ld_wd, 3 * R, pad8(L.v_in), pad16(h + 3), false, ZeroInit{},
                      [&](int m, int n, float v0, float v1) {
                        const float v[2] = {v0, v1};
#pragma unroll
                        for (int j = 0; j < 2; ++j) {
                          const int col = n + j;
                          if (col >= L.v_in) break;
                          const float val = v[j] + (L.vres ? f(dU[m * g.ldv + col]) : 0.f);
                          if (dmsg) {
                            const int r = m / 3, c = m - 3 * r;
                            if (r < rows) dmsg[r * in_dim + L.s_in + c * L.v_in + col] = __float2bfloat16_rn(val);
                          } else {
                            float* dv = s.dV + m * g.ldvf + col;
                            *dv = (pass_through ? *dv : 0.f) + val;
                          }
                        }
                      });
  }
  wgrad(s.X, g.ldx, L.v_in, false, s.dD, g.ldd, h + 3, 3 * R, P + L.off_wd);
  __syncthreads();
}

// Layer L's input state from the block's scratch slot into M and X.
__device__ void load_state(const Smem<bf16>& s, const Geom& g, const Layer& L, const bf16* slot) {
  const bf16* slot_v = slot + R * L.s_in;
  for (int i = threadIdx.x; i < R * L.s_in; i += kThreads) {
    const int r = i / L.s_in;
    s.M[r * g.ldm + (i - r * L.s_in)] = slot[i];
  }
  for (int i = threadIdx.x; i < 3 * R * L.v_in; i += kThreads) {
    const int rc = i / L.v_in;
    s.X[rc * g.ldx + (i - rc * L.v_in)] = slot_v[i];
  }
}

// Offset of layer l's input state (l >= 1) in a block's scratch.
__host__ __device__ inline long long slot_offset(const Stack& st, int l) {
  long long off = 0;
  for (int j = 1; j < l; ++j) off += static_cast<long long>(R) * (st.l[j].s_in + 3 * st.l[j].v_in);
  return off;
}

__global__ void __launch_bounds__(kThreads, 1)
edge_map_bwd_tc_kernel(const bf16* __restrict__ msg, const bf16* __restrict__ frames,
                       const bf16* __restrict__ gout, const char* __restrict__ images, const Stack st,
                       const Geom g, bf16* __restrict__ dmsg, float* __restrict__ partials,
                       bf16* __restrict__ scratch, long long w_len, long long stash_len,
                       long long num_edges) {
  extern __shared__ float4 smem4[];
  Smem<bf16> s;
  const size_t smem_bytes = carve(reinterpret_cast<char*>(smem4), g, &s, 1, true);
  const int tid = threadIdx.x;
  // every padding column starts (and stays) zero
  for (size_t i = tid; i < smem_bytes / sizeof(float4); i += kThreads) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float* P = partials + blockIdx.x * w_len;
  bf16* stash = scratch + blockIdx.x * stash_len;
  for (long long i = tid; i < w_len; i += kThreads) P[i] = 0.f;

  const int nl = st.n_layers;
  const Layer first = st.l[0];
  const Layer last = st.l[nl - 1];
  const int in_dim = first.s_in + 3 * first.v_in;
  const int out_dim = last.s_out + 3 * last.v_out;
  const long long num_tiles = (num_edges + R - 1) / R;
  for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const long long e0 = tile * R;
    const int rows = static_cast<int>(min(static_cast<long long>(R), num_edges - e0));
    __syncthreads();  // the smem and the block's partial are zeroed; the previous tile is done
    load_input(s, g, first, msg + e0 * in_dim, frames + e0 * 9, rows);
    // the cotangent of the stack's output
    for (int i = tid; i < R * out_dim; i += kThreads) {
      const int r = i / out_dim, col = i - r * out_dim;
      const float v = r < rows ? f(gout[e0 * out_dim + i]) : 0.f;
      if (col < last.s_out) {
        s.dY[r * g.ldy + col] = v;
      } else {
        const int j = col - last.s_out, c = j / last.v_out;
        s.dV[(r * 3 + c) * g.ldvf + (j - c * last.v_out)] = v;
      }
    }
    // the forward sweep, keeping each layer's input state in the block's
    // scratch; layer L-1's intermediates stay in shared memory
    for (int l = (kCut == kNoForwardSweep ? nl - 1 : 0); l < nl; ++l) {
      const Layer L = st.l[l];
      const char* image = images + l * g.img_bytes;
      load_weights(s, g, L, image);
      __syncthreads();
      layer_forward(s, g, L, image, NoHook{});
      if (l < nl - 1)
        layer_output(s, g, L, st.residual && l > 0,
                     kCut == kNoScratch ? nullptr : stash + slot_offset(st, l + 1));
    }
    // the reverse sweep
    for (int l = nl - 1; l >= 0; --l) {
      const Layer L = st.l[l];
      if (l < nl - 1) {
        if (l == 0) {
          load_input<bf16>(s, g, L, msg + e0 * in_dim, nullptr, rows);
        } else if (kCut != kNoScratch) {
          load_state(s, g, L, stash + slot_offset(st, l));
        }
        const char* image = images + l * g.img_bytes;
        load_weights(s, g, L, image);
        __syncthreads();
        if (kCut != kNoRecompute) layer_forward(s, g, L, image, NoHook{});
      }
      layer_backward(s, g, L, P, st.residual && l > 0, l == 0 ? dmsg + e0 * in_dim : nullptr, rows);
    }
  }
}

// Layer blockIdx.x's image (build_image) at images + layer * g.img_bytes.
__global__ void __launch_bounds__(kThreads)
edge_map_bwd_tc_images(const float* __restrict__ W, const Stack st, const Geom g, char* __restrict__ images) {
  build_image<bf16>(W, st.l[blockIdx.x], g, images + static_cast<size_t>(blockIdx.x) * g.img_bytes);
}

}  // namespace

// Bytes of the per-layer weight images gcp_edge_map_bwd_tc needs, for the
// layer table meta; -1 for a malformed table.
extern "C" long long gcp_edge_map_bwd_tc_image_bytes(const int* meta, int meta_len) {
  Stack st;
  if (!gcp::parse_stack(meta, meta_len, st)) return -1;
  return static_cast<long long>(st.n_layers) * geometry<bf16>(st).img_bytes;
}

// message [E, s_in + 3 v_in], frames [E, 9] (masked) and grad_out
// [E, s_out + 3 v_out] in bf16; d_msg [E, s_in + 3 v_in] out in bf16;
// weights and d_weights float32 [weights_len]; meta is K2's layer table
// (edge_stack.cuh parse_stack).  Workspace on the device: images
// [gcp_edge_map_bwd_tc_image_bytes] (16-byte aligned), partials float32
// [grid * weights_len] and scratch bf16 [grid * stash_len], stash_len at
// least 64 (kTile) * sum over layers l >= 1 of (s_in + 3 v_in).  grid is
// the number of persistent blocks (one per SM).  Returns
// cudaErrorInvalidValue for a malformed table or workspace,
// cudaErrorInvalidConfiguration when the widths need more shared memory
// than a block has, else cudaGetLastError() after the three launches (0 on
// success).
extern "C" int gcp_edge_map_bwd_tc(const void* msg, const void* frames, const void* grad_out,
                                   const float* weights, const int* meta, int meta_len, void* d_msg,
                                   float* d_weights, void* images, float* partials, void* scratch,
                                   long long weights_len, long long stash_len, long long num_edges,
                                   int grid, void* stream) {
  Stack st;
  if (!gcp::parse_stack(meta, meta_len, st)) return static_cast<int>(cudaErrorInvalidValue);
  if (grid < 1 || weights_len < 1 || stash_len < slot_offset(st, st.n_layers))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = geometry<bf16>(st);
  Smem<bf16> unused;
  const size_t smem = carve(nullptr, g, &unused, 1, true);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (num_edges <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* img = static_cast<char*>(images);
  edge_map_bwd_tc_images<<<st.n_layers, kThreads, 0, s>>>(weights, st, g, img);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(edge_map_bwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_map_bwd_tc_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(msg), static_cast<const bf16*>(frames),
      static_cast<const bf16*>(grad_out), img, st, g, static_cast<bf16*>(d_msg), partials,
      static_cast<bf16*>(scratch), weights_len, stash_len, num_edges);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return gcp::launch_sum_partials(partials, grid, weights_len, d_weights, s);
}
