// K3 in float32: the backward of the fused GCP2 message stack (K2),
// recomputing the stack's forward per tile of edge rows.  bf16 runs
// edge_map_bwd_tc.cu, on the tensor cores.
//
//   d_msg[e, :] = d_out[e, :] . d stack(msg[e, :], frames[e, :]) / d msg
//   d_W         = sum over e of d_out[e, :] . d stack(msg[e, :], frames[e, :]) / d W
//
// Replaces the TPU kernel of gcpnet_tpu/ops/pallas_fused.py (_map_bwd,
// pallas_call at :175): per block of rows it re-runs the stack under jax.vjp,
// writes d edge_data in the input dtype and accumulates the weight gradients
// in float32 across the TPU's sequential grid.  The frames get no gradient
// (in LBA they depend on no parameter).
//
// The layer math is K2's (edge_map_tc.cu:11-20).  Backward of one layer, per
// row (component c, dims s_in, v_in -> s_out, v_out, hidden h):
//   u_c = vh_c @ Wup (+ v_c);  dg = sum_c dv_c u_c;  du_c = dv_c g
//   vector gate:  dG = dg g (1 - g);  dWg += act_v(S)^T dG;  dS += (dG Wg^T) act_v'(S)
//   norm gate:    du_c += dg act_v'(n) u_c / sqrt(sum u^2 + eps)
//   dS += ds act_s'(S);  dM = dS Wso^T;  dWso += M^T dS;  dWup += vh^T du
//   dvh_c = du_c Wup^T + dvnorm vh_c / sqrt(sum vh^2 + eps)
//   ddf_a[ch] = sum_f dscal9[ch*3 + f] frame[3f + a]
//   dv_c = [dvh_c | ddf_c] [Wd | Wdf]^T (+ du_c);  d[Wd | Wdf] += v^T [dvh | ddf]
// and for ResGCP the state's cotangent passes through each residual add.
//
// Bound on the H100: operations.  Recompute plus backward is about three
// times the forward's 245 kFLOP per edge row: ~153 GFLOP per call at the
// main path's shape (208,896 rows, 8 layers, hidden 100/16) against ~700 MB
// of float32 inputs and outputs.
//
// Design:
// - Tile of 48 rows.  A 64-row tile's float32 activations take 146 KB of
//   shared memory in this layout; the backward needs one layer's cotangents beside
//   them (the gate's and u's written over their forward values, the input
//   vectors' over the output's): 224 KB at 48 rows, of the 227 KB a block may
//   use, as the TPU kernel shrinks its block (BWD_BLOCK = 256) for the same
//   reason.  Each tile adds its weight gradients to the partial once, so the
//   tile's height divides that traffic.
// - Activations: the forward sweep writes each layer's input state and
//   intermediates (D, vnorm and scal9, S, U, G: ~340 floats a row per layer
//   at the main path's widths) to a per-block scratch in global memory
//   (~507 KB per block, ~67 MB over the grid, partly L2-resident); the
//   reverse sweep reads a layer's back into shared memory before its
//   backward.  The stack's activations never exist in HBM for all rows at
//   once, as in the TPU kernel; recomputing each layer in the reverse sweep
//   instead costs ~12 ms per call at the main path's shape, more than the
//   scratch traffic.
// - Weight gradients, deterministically and without float atomics: a
//   persistent grid (one block per SM, the caller picks it) walks the tiles
//   in a fixed order; each block owns a float32 partial of all weights
//   (~620 KB) in global memory and adds each tile's products to it in place;
//   a second kernel sums the partials in block order.  That read-modify-write
//   costs ~8 GB of traffic per call at the main path's shape, ~2.4 ms at the
//   memory rate, accepted for a first version.
// - The products run on the CUDA cores in float32 with register micro-tiles
//   (edge_stack.cuh mm); tensor cores are later work.  The backward's products take
//   the weights transposed (a copy the wrapper makes), so that they read
//   weight rows as 16-byte vectors, as the forward's do; each block's
//   partial is updated with 16-byte read-modify-writes.

#include <cstdint>

#include "edge_stack.cuh"

namespace {

using gcp::act;
using gcp::act_grad;
using gcp::kEps;
using gcp::kFrameLd;
using gcp::kThreads;
using gcp::Layer;
using gcp::mm;
using gcp::Stack;

constexpr int kTile = 48;  // edge rows per tile

// P[k * N + n] += sum_{r < R} act(A[r][k]) * G[r][n]  for k < K, n < N: one
// tile's contribution to a weight gradient, added to the block's own float32
// partial (no other block writes it).  A == nullptr stands for a column of
// ones (a bias gradient, K = 1).  A and G live in shared memory with row
// strides that are multiples of 4 and at least round4(K) and round4(N): the
// 16-byte loads may read padding columns, whose products are never stored.
// Each thread owns a 4 x 4 block of P.
__device__ __forceinline__ void wgrad(const float* A, int lda, int R, int K, int act_a,
                                      const float* G, int ldg, int N, float* P) {
  const int kg = (K + 3) >> 2, ng = (N + 3) >> 2;
  // P's rows as 16-byte vectors where they are whole and aligned
  const bool p_vec = (N & 3) == 0 && (reinterpret_cast<uintptr_t>(P) & 15) == 0;
  for (int t = threadIdx.x; t < kg * ng; t += kThreads) {
    const int k0 = (t / ng) * 4, n0 = (t % ng) * 4;
    // the partial's current values, loaded first so that their latency
    // (they are mostly beyond L2) overlaps the products below
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* row = P + (k0 + i) * N + n0;
      if (k0 + i >= K) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      } else if (p_vec) {
        const float4 p = *reinterpret_cast<const float4*>(row);
        acc[i][0] = p.x;
        acc[i][1] = p.y;
        acc[i][2] = p.z;
        acc[i][3] = p.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = n0 + j < N ? row[j] : 0.f;
      }
    }
    for (int r = 0; r < R; ++r) {
      float a[4] = {1.f, 0.f, 0.f, 0.f};
      if (A) {
        const float4 a4 = *reinterpret_cast<const float4*>(A + r * lda + k0);
        a[0] = act(a4.x, act_a);
        a[1] = act(a4.y, act_a);
        a[2] = act(a4.z, act_a);
        a[3] = act(a4.w, act_a);
      }
      const float4 g4 = *reinterpret_cast<const float4*>(G + r * ldg + n0);
      const float g[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], g[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (k0 + i >= K) break;
      float* row = P + (k0 + i) * N + n0;
      if (p_vec) {
        *reinterpret_cast<float4*>(row) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + j < N) row[j] = acc[i][j];
      }
    }
  }
}

// Shared memory, float32: a tile of kTile rows' forward activations
// (gcp::Tile: M, X, D, S, G, U, F) and the cotangents
//   dY [R][lds], dV [3R][ldx]  of the state after the current layer; in a
//                layer's backward dV then takes the cotangent of its input
//                vectors (added to the state's, for ResGCP)
//   dS [R][lds]  of s_new;  dM [R][ldm] of M
//   dG           of the gate logits, over G (read once, where it is written)
//   dU           of the gated vector's pre-gate value u, over U (likewise)
//   dD [3R][ldd] of D
struct Smem : gcp::Tile {
  float *dY, *dS, *dM, *dG, *dV, *dU, *dD;
};

__host__ __device__ inline size_t smem_floats(const Stack& st) {
  return gcp::tile_floats<kTile>(st) + static_cast<size_t>(kTile) * (st.ldm + 2 * st.lds) +
         static_cast<size_t>(3 * kTile) * (st.ldx + st.ldd);
}

__device__ inline Smem carve(float* base, const Stack& st) {
  Smem s;
  static_cast<gcp::Tile&>(s) = gcp::carve_tile<kTile>(base, st);
  s.dY = s.F + kTile * kFrameLd;
  s.dS = s.dY + kTile * st.lds;
  s.dM = s.dS + kTile * st.lds;
  s.dV = s.dM + kTile * st.ldm;
  s.dD = s.dV + 3 * kTile * st.ldx;
  s.dG = s.G;
  s.dU = s.U;
  return s;
}

// Layer l's slot in the block's scratch, compact rows: its input state
// ([R][s_in] scalars, [3R][v_in] vectors; layers 1..L-1 only, layer 0 reads
// msg), then its intermediates D [3R][h+3], M[:, s_in:] [R][h+9], S
// [R][s_out], U [3R][v_out] and, with the vector gate, G [R][v_out].
__host__ __device__ inline long long slot_floats(const Layer& L, int l) {
  return static_cast<long long>(kTile) *
         ((l > 0 ? L.s_in + 3 * L.v_in : 0) + 3 * (L.h + 3) + L.h + 9 + L.s_out + 3 * L.v_out +
          (L.vgate ? L.v_out : 0));
}

__host__ __device__ inline long long slot_offset(const Stack& st, int l) {
  long long off = 0;
  for (int j = 0; j < l; ++j) off += slot_floats(st.l[j], j);
  return off;
}

// rows x cols between a shared-memory array with row stride ld and a
// compact global one
__device__ inline void copy_rows(float* smem, int ld, float* global, int rows, int cols,
                                 bool to_global) {
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols;
    float* p = smem + r * ld + (i - r * cols);
    if (to_global) {
      global[i] = *p;
    } else {
      *p = global[i];
    }
  }
}

// Layer L's intermediates between shared memory and its slot (past the
// input state, which starts at slot).
__device__ void copy_intermediates(const Smem& s, const Stack& st, const Layer& L, bool has_state,
                                   float* slot, bool to_global) {
  float* q = slot + (has_state ? kTile * (L.s_in + 3 * L.v_in) : 0);
  copy_rows(s.D, st.ldd, q, 3 * kTile, L.h + 3, to_global);
  q += 3 * kTile * (L.h + 3);
  copy_rows(s.M + L.s_in, st.ldm, q, kTile, L.h + 9, to_global);
  q += kTile * (L.h + 9);
  copy_rows(s.S, st.lds, q, kTile, L.s_out, to_global);
  q += kTile * L.s_out;
  copy_rows(s.U, st.ldv, q, 3 * kTile, L.v_out, to_global);
  q += 3 * kTile * L.v_out;
  if (L.vgate) copy_rows(s.G, st.ldv, q, kTile, L.v_out, to_global);
}

// Layer l's backward: from the cotangent (dY, dV) of its output and its
// intermediates, the weight gradients (added to P) and the cotangent of its
// input: scalars in dM[:, :s_in], vectors in dV (+ dU with the vector
// residual), where dV keeps the output's cotangent added when
// pass_through (ResGCP).  WT holds each weight matrix transposed, at the offsets
// of W, so that these products read B row by row, as the forward's do.
__device__ void layer_backward(const Smem& s, const Stack& st, const Layer& L,
                               const float* __restrict__ WT, float* P, bool pass_through) {
  const int tid = threadIdx.x;
  const int h = L.h, hk = L.h + 9;
  // the gates, elementwise
  for (int i = tid; i < kTile * L.v_out; i += kThreads) {
    const int r = i / L.v_out, o = i - r * L.v_out;
    float u[3], dv[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      u[c] = s.U[(r * 3 + c) * st.ldv + o] + (L.vres ? s.X[(r * 3 + c) * st.ldx + o] : 0.f);
      dv[c] = s.dV[(r * 3 + c) * st.ldx + o];
    }
    const float dg = dv[0] * u[0] + dv[1] * u[1] + dv[2] * u[2];
    float du[3];
    if (L.vgate) {
      const float g = 1.f / (1.f + expf(-s.G[r * st.ldv + o]));
      s.dG[r * st.ldv + o] = dg * g * (1.f - g);
#pragma unroll
      for (int c = 0; c < 3; ++c) du[c] = dv[c] * g;
    } else if (L.act_v) {
      const float rt = sqrtf(u[0] * u[0] + u[1] * u[1] + u[2] * u[2] + kEps);
      const float n = rt + kEps;
      const float g = act(n, L.act_v);
      const float dn = dg * act_grad(n, L.act_v) / rt;
#pragma unroll
      for (int c = 0; c < 3; ++c) du[c] = dv[c] * g + dn * u[c];
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) du[c] = dv[c];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) s.dU[(r * 3 + c) * st.ldv + o] = du[c];
  }
  for (int i = tid; i < kTile * L.s_out; i += kThreads) {
    const int r = i / L.s_out, o = i - r * L.s_out;
    s.dS[r * st.lds + o] = s.dY[r * st.lds + o] * act_grad(s.S[r * st.lds + o], L.act_s);
  }
  __syncthreads();
  if (L.vgate) {
    // dS += (dG @ Wg^T) act_v'(S), through dM as scratch
    mm<6>(s.dG, st.ldv, kTile, L.v_out, WT + L.off_wg, L.s_out, 1, L.s_out, nullptr, 0, s.dM, st.ldm,
          false);
    wgrad(s.S, st.lds, kTile, L.s_out, L.act_v, s.dG, st.ldv, L.v_out, P + L.off_wg);
    wgrad(nullptr, 0, kTile, 1, 0, s.dG, st.ldv, L.v_out, P + L.off_bg);
    __syncthreads();
    for (int i = tid; i < kTile * L.s_out; i += kThreads) {
      const int r = i / L.s_out, o = i - r * L.s_out;
      s.dS[r * st.lds + o] += s.dM[r * st.ldm + o] * act_grad(s.S[r * st.lds + o], L.act_v);
    }
    __syncthreads();
  }
  // dM = dS @ Wso^T;  dvh = dU @ Wup^T;  dWso, dbso, dWup
  mm<6>(s.dS, st.lds, kTile, L.s_out, WT + L.off_wso, L.s_in + hk, 1, L.s_in + hk, nullptr, 0, s.dM,
        st.ldm, false);
  mm<2>(s.dU, st.ldv, 3 * kTile, L.v_out, WT + L.off_wup, h, 1, h, nullptr, 0, s.dD, st.ldd, false);
  wgrad(s.M, st.ldm, kTile, L.s_in + hk, 0, s.dS, st.lds, L.s_out, P + L.off_wso);
  wgrad(nullptr, 0, kTile, 1, 0, s.dS, st.lds, L.s_out, P + L.off_bso);
  wgrad(s.D, st.ldd, 3 * kTile, h, 0, s.dU, st.ldv, L.v_out, P + L.off_wup);
  __syncthreads();
  // vnorm and scal9 back into [dvh | ddf]
  for (int i = tid; i < kTile * h; i += kThreads) {
    const int r = i / h, j = i - r * h;
    const float* d = s.D + r * 3 * st.ldd + j;
    const float x = d[0], y = d[st.ldd], z = d[2 * st.ldd];
    const float f = s.dM[r * st.ldm + L.s_in + j] / sqrtf(x * x + y * y + z * z + kEps);
    float* dd = s.dD + r * 3 * st.ldd + j;
    dd[0] += f * x;
    dd[st.ldd] += f * y;
    dd[2 * st.ldd] += f * z;
  }
  for (int i = tid; i < kTile * 9; i += kThreads) {
    const int r = i / 9, q = i - r * 9, ch = q / 3, a = q - 3 * ch;
    const float* dm = s.dM + r * st.ldm + L.s_in + h + ch * 3;
    const float* fr = s.F + r * kFrameLd + a;
    s.dD[(r * 3 + a) * st.ldd + h + ch] = dm[0] * fr[0] + dm[1] * fr[3] + dm[2] * fr[6];
  }
  __syncthreads();
  // dV (+)= [dvh | ddf] @ [Wd | Wdf]^T;  d[Wd | Wdf]
  mm<2>(s.dD, st.ldd, 3 * kTile, h + 3, WT + L.off_wd, L.v_in, 1, L.v_in, nullptr, 0, s.dV, st.ldx,
        pass_through);
  wgrad(s.X, st.ldx, 3 * kTile, L.v_in, 0, s.dD, st.ldd, h + 3, P + L.off_wd);
  __syncthreads();
}

// Layer L's input state from the block's scratch slot into M and X.
__device__ void load_state(const Smem& s, const Stack& st, const Layer& L, const float* slot) {
  const float* slot_v = slot + kTile * L.s_in;
  for (int i = threadIdx.x; i < kTile * L.s_in; i += kThreads) {
    const int r = i / L.s_in;
    s.M[r * st.ldm + (i - r * L.s_in)] = slot[i];
  }
  for (int i = threadIdx.x; i < 3 * kTile * L.v_in; i += kThreads) {
    const int rc = i / L.v_in;
    s.X[rc * st.ldx + (i - rc * L.v_in)] = slot_v[i];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
edge_map_bwd_kernel(const float* __restrict__ msg, const float* __restrict__ frames,
                    const float* __restrict__ gout, const float* __restrict__ W,
                    const float* __restrict__ WT, const Stack st,
                    float* __restrict__ dmsg, float* __restrict__ partials, float* __restrict__ scratch,
                    long long w_len, long long stash_len, long long num_edges) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(reinterpret_cast<float*>(smem4), st);
  const int tid = threadIdx.x;
  float* P = partials + blockIdx.x * w_len;
  float* stash = scratch + blockIdx.x * stash_len;
  for (long long i = tid; i < w_len; i += kThreads) P[i] = 0.f;

  const int nl = st.n_layers;
  const Layer first = st.l[0];
  const Layer last = st.l[nl - 1];
  const int in_dim = first.s_in + 3 * first.v_in;
  const int out_dim = last.s_out + 3 * last.v_out;
  const long long num_tiles = (num_edges + kTile - 1) / kTile;
  for (long long tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const long long e0 = tile * kTile;
    const int rows = static_cast<int>(min(static_cast<long long>(kTile), num_edges - e0));
    __syncthreads();  // the block's partial is zeroed; the previous tile is done
    gcp::load_input<kTile>(s, st, msg + e0 * in_dim, frames + e0 * 9, rows);
    // the cotangent of the stack's output
    for (int i = tid; i < kTile * out_dim; i += kThreads) {
      const int r = i / out_dim, col = i - r * out_dim;
      const float g = r < rows ? gout[e0 * out_dim + i] : 0.f;
      if (col < last.s_out) {
        s.dY[r * st.lds + col] = g;
      } else {
        const int j = col - last.s_out, c = j / last.v_out;
        s.dV[(r * 3 + c) * st.ldx + (j - c * last.v_out)] = g;
      }
    }
    __syncthreads();
    // the forward sweep, keeping each layer's input state and intermediates
    // in the block's scratch; layer L-1's stay in shared memory
    for (int l = 0; l < nl; ++l) {
      const Layer L = st.l[l];
      gcp::layer_forward<kTile>(s, st, L, W);
      if (l < nl - 1) {
        copy_intermediates(s, st, L, l > 0, stash + slot_offset(st, l), true);
        __syncthreads();  // the copy reads M[:, s_in:], which the output may overwrite
        gcp::layer_output<kTile>(s, st, L, st.residual && l > 0, stash + slot_offset(st, l + 1));
      }
    }
    // the reverse sweep
    for (int l = nl - 1; l >= 0; --l) {
      const Layer L = st.l[l];
      if (l < nl - 1) {
        float* slot = stash + slot_offset(st, l);
        if (l == 0) {
          gcp::load_input<kTile>(s, st, msg + e0 * in_dim, frames + e0 * 9, rows);
        } else {
          load_state(s, st, L, slot);
        }
        copy_intermediates(s, st, L, l > 0, slot, false);
        __syncthreads();
      }
      layer_backward(s, st, L, WT, P, st.residual && l > 0);
      // the cotangent of the layer's input: of the previous state (added to
      // the residual's pass-through), or d msg
      if (l > 0) {
        const bool add = st.residual;
        for (int i = tid; i < kTile * L.s_in; i += kThreads) {
          const int r = i / L.s_in, j = i - r * L.s_in;
          float* y = s.dY + r * st.lds + j;
          *y = (add ? *y : 0.f) + s.dM[r * st.ldm + j];
        }
        if (L.vres) {
          for (int i = tid; i < 3 * kTile * L.v_in; i += kThreads) {
            const int rc = i / L.v_in, j = i - rc * L.v_in;
            s.dV[rc * st.ldx + j] += s.dU[rc * st.ldv + j];
          }
        }
      } else {
        float* dst = dmsg + e0 * in_dim;
        for (int i = tid; i < rows * in_dim; i += kThreads) {
          const int r = i / in_dim, col = i - r * in_dim;
          float v;
          if (col < L.s_in) {
            v = s.dM[r * st.ldm + col];
          } else {
            const int j = col - L.s_in, c = j / L.v_in, jj = j - c * L.v_in;
            const int rc = r * 3 + c;
            v = s.dV[rc * st.ldx + jj] + (L.vres ? s.dU[rc * st.ldv + jj] : 0.f);
          }
          dst[i] = v;
        }
      }
      __syncthreads();
    }
  }
}

int launch(const float* msg, const float* frames, const float* gout, const float* weights,
           const float* weights_t, const Stack& st, float* dmsg, float* dweights, float* partials,
           float* scratch, long long w_len, long long stash_len, long long num_edges, int grid,
           cudaStream_t stream) {
  const size_t smem = smem_floats(st) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(edge_map_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_map_bwd_kernel<<<grid, kThreads, smem, stream>>>(msg, frames, gout, weights, weights_t, st, dmsg,
                                                        partials, scratch, w_len, stash_len, num_edges);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return gcp::launch_sum_partials(partials, grid, w_len, dweights, stream);
}

}  // namespace

// message [E, s_in + 3 v_in], frames [E, 9] (masked), grad_out
// [E, s_out + 3 v_out] and d_msg [E, s_in + 3 v_in] out, all float32 (bf16
// runs edge_map_bwd_tc.cu); weights and d_weights float32 [weights_len], and
// weights_t the same buffer with each matrix transposed in place; meta is
// K2's HOST layer table (edge_stack.cuh parse_stack), every matrix at an offset that is a
// multiple of 4.  Workspace, float32 on the device: partials
// [grid * weights_len] and scratch [grid * stash_len], stash_len at least 48
// (kTile) * sum over layers l of ((l > 0 ? s_in + 3 v_in : 0) + 3 (h + 3)
// + h + 9 + s_out + 3 v_out + (vgate ? v_out : 0)).  grid is the number of
// persistent blocks (one per SM).  Returns cudaGetLastError() after the two
// launches (0 on success).
extern "C" int gcp_edge_map_bwd(const float* msg, const float* frames, const float* grad_out,
                                const float* weights, const float* weights_t,
                                const int* meta, int meta_len,
                                float* d_msg, float* d_weights, float* partials, float* scratch,
                                long long weights_len, long long stash_len, long long num_edges,
                                int grid, void* stream) {
  Stack st;
  if (!gcp::parse_stack(meta, meta_len, st)) return static_cast<int>(cudaErrorInvalidValue);
  if (grid < 1 || weights_len < 1 || (weights_len & 3) != 0 ||
      stash_len < slot_offset(st, st.n_layers))
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_edges <= 0) return 0;
  return launch(msg, frames, grad_out, weights, weights_t, st, d_msg, d_weights, partials, scratch,
                weights_len, stash_len, num_edges, grid, static_cast<cudaStream_t>(stream));
}
