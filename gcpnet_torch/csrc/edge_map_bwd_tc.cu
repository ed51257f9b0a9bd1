// K3: the backward of the fused GCP2 message stack (K2) on the tensor
// cores, recomputing the stack's forward per tile of edge rows, in bf16 and
// in float32.
//
//   d_msg[e, :] = d_out[e, :] . d stack(msg[e, :], frames[e, :]) / d msg
//   d_W         = sum over e of d_out[e, :] . d stack(msg[e, :], frames[e, :]) / d W
//
// Replaces the TPU kernel of gcpnet_tpu/ops/pallas_fused.py (_map_bwd,
// pallas_call at :175), which per block of rows re-runs the stack under
// jax.vjp with float32 accumulators, writes d edge_data in the input dtype
// and accumulates the weight gradients in float32.  The frames get no
// gradient (in LBA they depend on no parameter).  The arithmetic is
// edge_stack_mma.cuh's: bf16 operands with float32 accumulators, or
// float32 as split TF32, every product on the tensor cores.
//
// Per layer (K2's math, edge_map_tc.cu), with cotangents dY of the scalars
// and dV of the vectors after it:
// (act_s, act_v: any code of the layer table, edge_stack.cuh ActCode; act' their derivatives)
//   vector gate: dG = sigmoid'(G) (dV . vu) (G the gate logits), dvu = dV g
//   norm gate:   dvu = dV g + act_v'(n) (dV . vu) vu / sqrt(|vu|^2 + eps)
//   dS = dY act_s'(S) (+ (dG Wg^T) act_v'(S)),  dWg = act_v(S)^T dG
//   d[s | vnorm | scal9] = dS Wso^T,  dWso = [s | vnorm | scal9]^T dS
//   dvh = dvu Wup^T + dvnorm vh / sqrt(|vh|^2 + eps),  dWup = vh^T dvu
//   ddf from dscal9 and the frames;  dv = [dvh | ddf] [Wd | Wdf]^T (+ dvu),
//   d[Wd | Wdf] = v^T [dvh | ddf]
//
// Bound on the H100: operations.  Recompute plus backward is about three
// times the forward's 245 kFLOP per edge row: ~153 GFLOP per call at the
// main path's shape (208,896 rows, 8 layers, hidden 100/16): 0.155 ms at
// the bf16 tensor-core peak, and in float32, three TF32 products for each,
// 0.93 ms at the TF32 peak; ~350 / ~700 MB of inputs and outputs (0.105 /
// 0.21 ms).
//
// Design:
// - Tiles of R rows (bf16 64, float32 32; half as many for a stack too wide
//   for them, tile_rows), 512 threads, one block per SM.
//   The tile's activations, one layer's staged weights (layer 0's Wso is
//   the largest: [256][104] in bf16, two chunks of [104][128] in float32,
//   one in shared memory at a time), the float32 cotangents of the state
//   and the cotangents that feed products (in T) take 219 KB in bf16 and
//   188 KB in float32 of the 227 KB a block may use at the main path's
//   widths (48 float32 rows would take 250 KB).
// - Every product is a warp-level mma.sync (gcp::tc::gemm): the forward's
//   X Wd, M Wso, vh Wup, act(S) Wg; the backward's dG Wg^T, dS Wso^T,
//   dU Wup^T, dD Wd^T, which read the staged weights the other way (bf16
//   through ldmatrix, float32 a word a lane), so no transposed copy exists;
//   and the weight gradients A^T G, whose reduction runs over the tile's
//   rows (A read across its rows: ldmatrix.trans in bf16, a word a lane in
//   float32).  float32 Wso's chunks are taken in reverse for dS Wso^T: the
//   recompute leaves the last in shared memory.
// - Between the sweeps only each layer's input state is kept, in T, in a
//   per-block scratch in global memory (148 values a row per layer at the
//   main path's widths); the reverse sweep recomputes a layer's
//   intermediates from it with K2's own layer functions before its
//   backward, so it rebuilds K2's state bit for bit.
// - Weight gradients, deterministically and without float atomics: a
//   persistent grid (one block per SM) walks the tiles in a fixed order;
//   each block owns a float32 partial of all weights in global memory, whose
//   values are the starting accumulators of each tile's weight-gradient
//   products and are stored back after them; a second kernel sums the
//   partials in block order.
// - The cotangent of layer 0's input goes from the products' epilogues
//   straight to d msg.
// - Built for the bound of the stack's activation codes (edge_stack.cuh
//   ActCode, launch_codes): codes 0-2 and 0-3 here, as before selu, gelu,
//   sigmoid and tanh joined the layer table (the same code, at the same
//   registers); every code in edge_map_bwd_tc_all.cu's library, which
//   resolves each of selu, gelu, sigmoid and tanh once a layer into a copy
//   of the code of its own (values and derivatives), and whose vector gate
//   takes its two derivatives in two elementwise passes after the dG Wg^T
//   product.
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

using gcp::sigmoid;
using gcp::with_act_grad;
using gcp::kEps;
using gcp::kFrameLd;
using gcp::Layer;
using gcp::Stack;
using gcp::store_f;
using namespace gcp::tc;

enum Cut {
  kWhole = 0,
  kNoPartials = 1,          // weight-gradient products start at 0 and are not stored
  kNoWeightGrads = 2,       // no weight-gradient products or bias sums
  kNoScratch = 3,           // no input state written to or read from the scratch
  kNoForwardSweep = 4,      // the forward sweep runs the last layer only
  kNoRecompute = 5,         // the reverse sweep recomputes no layer
  kNoBackwardProducts = 6   // no dG Wg^T, dS Wso^T, dU Wup^T, dD Wd^T
};
constexpr int kCut = K3_CUT;

// edge rows per tile: a float32 row takes ~1.6 times a bf16 row's bytes
template <typename T>
constexpr int kRows = sizeof(T) == 2 ? kTile : kTile / 2;

// Shared-memory bytes of a tile of R rows.
template <typename T, int R>
size_t tile_smem(const Geom& g) {
  Smem<T> unused;
  return carve<T, R>(nullptr, g, &unused, 1, true);
}

// The tile height a stack takes: kRows<T>, or half as many rows where
// kRows<T>'s tile does not fit a block's shared memory (wide stacks, such
// as AR's: 68 vector channels in, 32 out); 0 where neither fits.  *smem
// gets the chosen tile's bytes.
template <typename T>
int tile_rows(const Geom& g, size_t* smem) {
  *smem = tile_smem<T, kRows<T>>(g);
  if (*smem <= static_cast<size_t>(kMaxSmem)) return kRows<T>;
  *smem = tile_smem<T, kRows<T> / 2>(g);
  if (*smem <= static_cast<size_t>(kMaxSmem)) return kRows<T> / 2;
  return 0;
}

// P[m * N + n] += sum over rows r < rows_red of A(r, m) G(r, n), for m < M,
// n < N: one tile's contribution to a weight gradient, added to the block's
// float32 partial (no other block writes it).  A [rows_red][lda] and
// G [rows_red][ldg] are tile arrays; with kActA, A goes through the
// activation act_a (gemm's).
template <int kActA = 0, typename T>
__device__ __forceinline__ void wgrad(const T* A, int lda, int M, Act act_a, const T* G, int ldg, int N,
                                      int rows_red, float* P) {
  if constexpr (kCut == kNoWeightGrads) return;
  gemm<T, true, false, kActA>(
      A, lda, G, ldg, pad16(M), pad8(N), rows_red, act_a,
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

// P[n] += sum over the tile's R rows of G[r][n], n < N (a bias gradient)
template <int R, typename T>
__device__ __forceinline__ void bias_grad(const T* G, int ldg, int N, float* P) {
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
// rows.  s.wso holds Wso's last chunk; the others (float32) are copied
// from image.  The layer's activation codes are below kCodes
// (edge_stack.cuh with_act_grad).
template <typename T, int R, int kCodes>
__device__ void layer_backward(const Smem<T>& s, const Geom& g, const Layer& L, const char* image, float* P,
                               bool pass_through, T* dmsg, int rows) {
  constexpr bool kWT = kWeightsT<T>;
  const int tid = threadIdx.x;
  const int h = L.h, hk = h + 9, K = L.s_in + hk;
  const int in_dim = L.s_in + 3 * L.v_in;
  // the gates, elementwise: dG over G, dU over U (a copy for each
  // transcendental derivative in the norm gate)
  with_act_grad<kCodes>(L.vgate ? 0 : L.act_v, L.slope, [&](auto act_v_grad) {
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
        const float gt = sigmoid(f(s.G[r * g.ldv + o]));
        store_f(s.G + r * g.ldv + o, dg * gt * (1.f - gt));
#pragma unroll
        for (int c = 0; c < 3; ++c) du[c] = dv[c] * gt;
      } else if (L.act_v) {
        const float rt = sqrtf(u[0] * u[0] + u[1] * u[1] + u[2] * u[2] + kEps);
        const float n = rt + kEps;
        float gt;
        if constexpr (kCodes > gcp::kActSelu) {
          gt = gcp::act_of<decltype(act_v_grad)::kCode>(n, L.act_v, L.slope);
        } else {
          gt = gcp::act_of_code<kCodes>(n, L.act_v, L.slope);
        }
        const float dn = dg * act_v_grad(n) / rt;
#pragma unroll
        for (int c = 0; c < 3; ++c) du[c] = dv[c] * gt + dn * u[c];
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) du[c] = dv[c];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) store_f(s.U + (r * 3 + c) * g.ldv + o, du[c]);
    }
  });
  if (!L.vgate) {
    with_act_grad<kCodes>(L.act_s, L.slope, [&](auto act_s_grad) {
      for (int i = tid; i < R * L.s_out; i += kThreads) {
        const int r = i / L.s_out, o = i - r * L.s_out;
        store_f(s.dS + r * g.lds + o, s.dY[r * g.ldy + o] * act_s_grad(f(s.S[r * g.lds + o])));
      }
    });
  }
  __syncthreads();
  const T* dG = s.G;
  const T* dU = s.U;
  if (L.vgate) {
    // dS = dY act_s'(S) + (dG Wg^T) act_v'(S);  dWg += act_v(S)^T dG;  dbg
    if constexpr (kCut != kNoBackwardProducts) {
      if constexpr (kCodes > gcp::kActSelu) {
        // selu, gelu, sigmoid or tanh: dG Wg^T into dS (rounded to T, as the
        // plain version rounds it), then one elementwise pass a derivative,
        // each resolved once (one copy of the product, not one a pair of
        // derivatives); each thread takes the same elements in both passes
        gemm<T, false, !kWT>(dG, g.ldv, s.wg, g.ld_wg, R, pad8(L.s_out), padk<T>(L.v_out), Act{}, ZeroInit{},
                             [&](int m, int n, float v0, float v1) {
                               put2(s.dS + m * g.lds + n, n, L.s_out, v0, v1);
                             });
        __syncthreads();
        with_act_grad<kCodes>(L.act_v, L.slope, [&](auto act_v_grad) {
          for (int i = tid; i < R * L.s_out; i += kThreads) {
            const int r = i / L.s_out, o = i - r * L.s_out;
            T* ds = s.dS + r * g.lds + o;
            store_f(ds, f(*ds) * act_v_grad(f(s.S[r * g.lds + o])));
          }
        });
        with_act_grad<kCodes>(L.act_s, L.slope, [&](auto act_s_grad) {
          for (int i = tid; i < R * L.s_out; i += kThreads) {
            const int r = i / L.s_out, o = i - r * L.s_out;
            T* ds = s.dS + r * g.lds + o;
            store_f(ds, f(*ds) + s.dY[r * g.ldy + o] * act_s_grad(f(s.S[r * g.lds + o])));
          }
        });
      } else {
        // one copy of the product a pair of derivatives (ActGrad or SiluGrad)
        with_act_grad<kCodes>(L.act_s, L.slope, [&](auto act_s_grad) {
          with_act_grad<kCodes>(L.act_v, L.slope, [&](auto act_v_grad) {
            gemm<T, false, !kWT>(dG, g.ldv, s.wg, g.ld_wg, R, pad8(L.s_out), padk<T>(L.v_out), Act{}, ZeroInit{},
                                 [&](int m, int n, float v0, float v1) {
                                   const float v[2] = {v0, v1};
#pragma unroll
                                   for (int j = 0; j < 2; ++j) {
                                     if (n + j >= L.s_out) break;
                                     const float sv = f(s.S[m * g.lds + n + j]);
                                     store_f(s.dS + m * g.lds + n + j,
                                             s.dY[m * g.ldy + n + j] * act_s_grad(sv) + v[j] * act_v_grad(sv));
                                   }
                                 });
          });
        });
      }
    }
    if (L.act_v) {
      gcp::with_act_code<kCodes>(L.act_v, [&](auto code) {
        wgrad<kActAOf<kCodes, decltype(code)::value>>(s.S, g.lds, L.s_out, Act{L.act_v, L.slope}, dG, g.ldv, L.v_out,
                                                      R, P + L.off_wg);
      });
    } else {
      wgrad(s.S, g.lds, L.s_out, Act{}, dG, g.ldv, L.v_out, R, P + L.off_wg);
    }
    bias_grad<R>(dG, g.ldv, L.v_out, P + L.off_bg);
    __syncthreads();
  }
  // dM = dS Wso^T: its first s_in columns into dY (or d msg), the rest
  // (vnorm's and scal9's) into dMs;  dWso += M^T dS;  dbso
  if constexpr (kCut != kNoBackwardProducts) {
    // columns k0 .. k0 + np of dM from the Wso chunk in s.wso
    auto dm = [&](int k0, int np) {
      gemm<T, false, !kWT>(s.dS, g.lds, s.wso, g.ld_wso, R, np, padk<T>(L.s_out), Act{}, ZeroInit{},
                           [&](int m, int n, float v0, float v1) {
                             const float v[2] = {v0, v1};
#pragma unroll
                             for (int j = 0; j < 2; ++j) {
                               const int col = k0 + n + j;
                               if (col >= K) break;
                               if (col >= L.s_in) {
                                 s.dMs[m * g.ldms + col - L.s_in] = v[j];
                               } else if (dmsg) {
                                 if (m < rows) store_f(dmsg + m * in_dim + col, v[j]);
                               } else {
                                 float* y = s.dY + m * g.ldy + col;
                                 *y = (pass_through ? *y : 0.f) + v[j];
                               }
                             }
                           });
    };
    if constexpr (kWT) {
      // float32: over Wso's chunks, the last (still in s.wso) first
      const int chunks = wso_chunks(g, padk<T>(K));
      for (int c = chunks - 1; c >= 0; --c) {
        if (c < chunks - 1) {
          __syncthreads();
          copy_async(reinterpret_cast<char*>(s.wso), image + g.w_off_wso + c * g.wso_bytes, g.wso_bytes);
          cp_async_wait();
          __syncthreads();
        }
        dm(c * g.wso_k, pad8(min(g.wso_k, K - c * g.wso_k)));
      }
    } else {
      dm(0, pad8(K));
    }
  }
  wgrad(s.M, g.ldm, K, Act{}, s.dS, g.lds, L.s_out, R, P + L.off_wso);
  bias_grad<R>(s.dS, g.lds, L.s_out, P + L.off_bso);
  __syncthreads();
  // dD[:, :h] = dU Wup^T + the vnorm's part;  dD[:, h:] from scal9's;  dWup += vh^T dU
  if constexpr (kCut != kNoBackwardProducts) {
    gemm<T, false, !kWT>(dU, g.ldv, s.wup, g.ld_wup, 3 * R, pad8(h), padk<T>(L.v_out), Act{}, ZeroInit{},
                         [&](int m, int n, float v0, float v1) {
                           const float v[2] = {v0, v1};
                           const int r = m / 3;
                           const T* d = s.D + r * 3 * g.ldd;
#pragma unroll
                           for (int j = 0; j < 2; ++j) {
                             const int col = n + j;
                             if (col >= h) break;
                             const float x = f(d[col]), y = f(d[g.ldd + col]), z = f(d[2 * g.ldd + col]);
                             const float fac = s.dMs[r * g.ldms + col] / sqrtf(x * x + y * y + z * z + kEps);
                             store_f(s.dD + m * g.ldd + col, v[j] + fac * f(s.D[m * g.ldd + col]));
                           }
                         });
  }
  for (int i = tid; i < R * 9; i += kThreads) {
    const int r = i / 9, q = i - r * 9, ch = q / 3, a = q - 3 * ch;
    const float* dm = s.dMs + r * g.ldms + h + ch * 3;
    const float* fr = s.F + r * kFrameLd + a;
    store_f(s.dD + (r * 3 + a) * g.ldd + h + ch, dm[0] * fr[0] + dm[1] * fr[3] + dm[2] * fr[6]);
  }
  wgrad(s.D, g.ldd, h, Act{}, dU, g.ldv, L.v_out, 3 * R, P + L.off_wup);
  __syncthreads();
  // dV (+)= [dvh | ddf] [Wd | Wdf]^T (+ dU with the vector residual), or d
  // msg's vectors;  d[Wd | Wdf] += X^T [dvh | ddf]
  if constexpr (kCut != kNoBackwardProducts) {
    gemm<T, false, !kWT>(s.dD, g.ldd, s.wd, g.ld_wd, 3 * R, pad8(L.v_in), padk<T>(h + 3), Act{},
                         ZeroInit{}, [&](int m, int n, float v0, float v1) {
                           const float v[2] = {v0, v1};
#pragma unroll
                           for (int j = 0; j < 2; ++j) {
                             const int col = n + j;
                             if (col >= L.v_in) break;
                             const float val = v[j] + (L.vres ? f(dU[m * g.ldv + col]) : 0.f);
                             if (dmsg) {
                               const int r = m / 3, c = m - 3 * r;
                               if (r < rows) store_f(dmsg + r * in_dim + L.s_in + c * L.v_in + col, val);
                             } else {
                               float* dv = s.dV + m * g.ldvf + col;
                               *dv = (pass_through ? *dv : 0.f) + val;
                             }
                           }
                         });
  }
  wgrad(s.X, g.ldx, L.v_in, Act{}, s.dD, g.ldd, h + 3, 3 * R, P + L.off_wd);
  __syncthreads();
}

// Layer L's input state from the block's scratch slot into M and X.
template <typename T, int R>
__device__ void load_state(const Smem<T>& s, const Geom& g, const Layer& L, const T* slot) {
  const T* slot_v = slot + R * L.s_in;
  for (int i = threadIdx.x; i < R * L.s_in; i += kThreads) {
    const int r = i / L.s_in;
    s.M[r * g.ldm + (i - r * L.s_in)] = slot[i];
  }
  for (int i = threadIdx.x; i < 3 * R * L.v_in; i += kThreads) {
    const int rc = i / L.v_in;
    s.X[rc * g.ldx + (i - rc * L.v_in)] = slot_v[i];
  }
}

// Offset of layer l's input state (l >= 1) in a block's scratch, for tiles
// of R rows.
template <int R>
__host__ __device__ inline long long slot_offset(const Stack& st, int l) {
  long long off = 0;
  for (int j = 1; j < l; ++j) off += static_cast<long long>(R) * (st.l[j].s_in + 3 * st.l[j].v_in);
  return off;
}

template <typename T, int R, int kCodes>
__global__ void __launch_bounds__(kThreads, 1)
edge_map_bwd_tc_kernel(const T* __restrict__ msg, const T* __restrict__ frames, const T* __restrict__ gout,
                       const char* __restrict__ images, const Stack st, const Geom g, T* __restrict__ dmsg,
                       float* __restrict__ partials, T* __restrict__ scratch, long long w_len,
                       long long stash_len, long long num_edges) {
  extern __shared__ float4 smem4[];
  Smem<T> s;
  const size_t smem_bytes = carve<T, R>(reinterpret_cast<char*>(smem4), g, &s, 1, true);
  const int tid = threadIdx.x;
  // every padding column starts (and stays) zero
  for (size_t i = tid; i < smem_bytes / sizeof(float4); i += kThreads) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float* P = partials + blockIdx.x * w_len;
  T* stash = scratch + blockIdx.x * stash_len;
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
    load_input<T, R>(s, g, first, msg + e0 * in_dim, frames + e0 * 9, rows);
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
      layer_forward<T, R, kCodes>(s, g, L, image, NoHook{});
      if (l < nl - 1)
        layer_output<T, R, kCodes>(s, g, L, st.residual && l > 0,
                           kCut == kNoScratch ? nullptr : stash + slot_offset<R>(st, l + 1));
    }
    // the reverse sweep
    for (int l = nl - 1; l >= 0; --l) {
      const Layer L = st.l[l];
      if (l < nl - 1) {
        const char* image = images + l * g.img_bytes;
        if (l == 0) {
          load_input<T, R>(s, g, L, msg + e0 * in_dim, nullptr, rows);
        } else if (kCut != kNoScratch) {
          load_state<T, R>(s, g, L, stash + slot_offset<R>(st, l));
        }
        load_weights(s, g, L, image);
        __syncthreads();
        if (kCut != kNoRecompute) layer_forward<T, R, kCodes>(s, g, L, image, NoHook{});
      }
      layer_backward<T, R, kCodes>(s, g, L, kWeightsT<T> ? images + l * g.img_bytes : nullptr, P, st.residual && l > 0,
                                   l == 0 ? dmsg + e0 * in_dim : nullptr, rows);
    }
  }
}

// Layer blockIdx.x's image (build_image) at images + layer * g.img_bytes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
edge_map_bwd_tc_images(const float* __restrict__ W, const Stack st, const Geom g, char* __restrict__ images) {
  build_image<T>(W, st.l[blockIdx.x], g, images + static_cast<size_t>(blockIdx.x) * g.img_bytes);
}

template <typename T, int R, int kCodes>
int launch_rows(const void* msg, const void* frames, const void* grad_out, const float* weights, const Stack& st,
                const Geom& g, size_t smem, void* d_msg, float* d_weights, void* images, float* partials,
                void* scratch, long long weights_len, long long stash_len, long long num_edges, int grid,
                cudaStream_t s) {
  if (stash_len < slot_offset<R>(st, st.n_layers)) return static_cast<int>(cudaErrorInvalidValue);
  if (num_edges <= 0) return 0;
  char* img = static_cast<char*>(images);
  edge_map_bwd_tc_images<T><<<st.n_layers, kThreads, 0, s>>>(weights, st, g, img);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(edge_map_bwd_tc_kernel<T, R, kCodes>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_map_bwd_tc_kernel<T, R, kCodes><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(msg), static_cast<const T*>(frames), static_cast<const T*>(grad_out), img, st, g,
      static_cast<T*>(d_msg), partials, static_cast<T*>(scratch), weights_len, stash_len, num_edges);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return gcp::launch_sum_partials(partials, grid, weights_len, d_weights, s);
}

// launch_rows for the bound of the stack's activation codes (edge_stack.cuh
// stack_codes).  This source builds the kernels for codes 0-2 and 0-3 (the
// code they ran before selu, gelu, sigmoid and tanh joined the layer
// table); edge_map_bwd_tc_all.cu, which includes it with
// GCP_K3_EVERY_CODE, builds those for every code: a library of its own,
// compiled beside this one, so that the build takes no longer than before.
// Each returns cudaErrorInvalidValue for the other's stacks.
template <typename T, int R, typename... Args>
int launch_codes(int codes, Args... args) {
#ifdef GCP_K3_EVERY_CODE
  if (codes == gcp::kActCodes) return launch_rows<T, R, gcp::kActCodes>(args...);
#else
  if (codes == gcp::kActSilu) return launch_rows<T, R, gcp::kActSilu>(args...);
  if (codes == gcp::kActSelu) return launch_rows<T, R, gcp::kActSelu>(args...);
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const void* msg, const void* frames, const void* grad_out, const float* weights, const Stack& st,
           void* d_msg, float* d_weights, void* images, float* partials, void* scratch, long long weights_len,
           long long stash_len, long long num_edges, int grid, cudaStream_t s) {
  const Geom g = geometry<T>(st);
  size_t smem;
  const int rows = tile_rows<T>(g, &smem);
  const int codes = gcp::stack_codes(st);
  if (rows == kRows<T>)
    return launch_codes<T, kRows<T>>(codes, msg, frames, grad_out, weights, st, g, smem, d_msg, d_weights, images,
                                     partials, scratch, weights_len, stash_len, num_edges, grid, s);
  if (rows == kRows<T> / 2)
    return launch_codes<T, kRows<T> / 2>(codes, msg, frames, grad_out, weights, st, g, smem, d_msg, d_weights,
                                         images, partials, scratch, weights_len, stash_len, num_edges, grid, s);
  return static_cast<int>(cudaErrorInvalidConfiguration);
}

}  // namespace

// Bytes of the per-layer weight images gcp_edge_map_bwd_tc needs, for the
// layer table meta and dtype (gcp::DType); -1 for a malformed table or
// dtype.
extern "C" long long gcp_edge_map_bwd_tc_image_bytes(const int* meta, int meta_len, int dtype) {
  Stack st;
  if (!gcp::parse_stack(meta, meta_len, st)) return -1;
  if (dtype == gcp::kF32) return static_cast<long long>(st.n_layers) * geometry<float>(st).img_bytes;
  if (dtype == gcp::kBF16) return static_cast<long long>(st.n_layers) * geometry<bf16>(st).img_bytes;
  return -1;
}

// Edge rows per tile of gcp_edge_map_bwd_tc for the layer table meta and
// dtype (gcp::DType): kRows, or half of it for a stack too wide for
// kRows' tile (tile_rows); 0 when no tile fits, -1 for a malformed table or
// dtype.  With smem_bytes not null, the tile's shared memory goes there.
extern "C" int gcp_edge_map_bwd_tc_tile(const int* meta, int meta_len, int dtype, long long* smem_bytes) {
  Stack st;
  if (!gcp::parse_stack(meta, meta_len, st)) return -1;
  size_t smem = 0;
  int rows = -1;
  if (dtype == gcp::kF32) rows = tile_rows<float>(geometry<float>(st), &smem);
  if (dtype == gcp::kBF16) rows = tile_rows<bf16>(geometry<bf16>(st), &smem);
  if (smem_bytes) *smem_bytes = static_cast<long long>(smem);
  return rows;
}

// message [E, s_in + 3 v_in], frames [E, 9] (masked) and grad_out
// [E, s_out + 3 v_out] in, d_msg [E, s_in + 3 v_in] out, all of dtype
// (gcp::DType); weights and d_weights float32 [weights_len]; meta is K2's
// HOST layer table (edge_stack.cuh parse_stack).  Workspace on the device:
// images [gcp_edge_map_bwd_tc_image_bytes] (16-byte aligned), partials
// float32 [grid * weights_len] and scratch of dtype [grid * stash_len],
// stash_len at least gcp_edge_map_bwd_tc_tile * sum over layers l >= 1 of
// (s_in + 3 v_in).  grid is the number of persistent blocks (one per SM).
// Returns cudaErrorInvalidValue for a malformed table, dtype or workspace,
// or a stack whose codes this build does not carry (launch_codes),
// cudaErrorInvalidConfiguration when the widths need more shared memory
// than a block has, else cudaGetLastError() after the three launches (0 on
// success).
extern "C" int gcp_edge_map_bwd_tc(const void* msg, const void* frames, const void* grad_out,
                                   const float* weights, const int* meta, int meta_len, void* d_msg,
                                   float* d_weights, void* images, float* partials, void* scratch,
                                   long long weights_len, long long stash_len, long long num_edges,
                                   int grid, int dtype, void* stream) {
  Stack st;
  if (!gcp::parse_stack(meta, meta_len, st)) return static_cast<int>(cudaErrorInvalidValue);
  if (grid < 1 || weights_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == gcp::kF32)
    return launch<float>(msg, frames, grad_out, weights, st, d_msg, d_weights, images, partials, scratch,
                         weights_len, stash_len, num_edges, grid, s);
  if (dtype == gcp::kBF16)
    return launch<bf16>(msg, frames, grad_out, weights, st, d_msg, d_weights, images, partials, scratch,
                        weights_len, stash_len, num_edges, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
