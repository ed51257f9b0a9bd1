// The message stack's bf16 layer body on the tensor cores, used by the bf16
// K3 (edge_map_bwd_tc.cu): a tile of edge rows in shared memory as bf16,
// each layer's weights staged beside it as bf16, and every product a
// warp-level mma.sync m16n8k16 (bf16 operands, float32 accumulators) fed by
// ldmatrix.  The numerics are the JAX kernel's (gcpnet_tpu/ops/
// pallas_fused.py:87-89 with gcp._mm): operands of every product in bf16,
// accumulators in float32, each product's output rounded to bf16 where it
// is stored; norms, square roots, sigmoids, relu masks and the frame
// contractions in float32 registers.  The layer table is K2's
// (edge_stack.cuh); K2 and the float32 K3 keep that header's body.
//
// Padding: a product runs on M, N and K rounded up to the mma shape (M and
// K to 16, N to 8).  The weights are staged with zeros in their padding rows
// and columns, and every activation array starts zeroed and is written only
// in its real columns, so the padding of one operand meets zeros or finite
// values in the other and adds nothing; results are stored for the real
// rows and columns only.
#pragma once

#include <cstdint>

#include "edge_stack.cuh"

namespace gcp {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // edge rows per tile (a multiple of 16)
constexpr int kThreads = 512;  // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // bytes a block may use on the H100

__host__ __device__ inline int pad8(int x) { return (x + 7) & ~7; }
__host__ __device__ inline int pad16(int x) { return (x + 15) & ~15; }
// A bf16 row stride of at least x elements whose count of 16-byte units is
// odd, so that the eight rows one ldmatrix reads fall on distinct banks.
__host__ __device__ inline int ld_bf16(int x) {
  const int l = pad8(x);
  return ((l >> 3) & 1) ? l : l + 8;
}

// Row strides (elements) and staged-weight rows, the same for every layer:
// each is the largest any layer needs.
struct Geom {
  int ldm, ldx, ldd, lds, ldv;                  // bf16 tile: M, X, D (dD), S (dS), G U (dG dU)
  int ld_wso, r_wso, ld_wd, r_wd, ld_wup, r_wup, ld_wg, r_wg;  // staged weights
  int n_bso, n_bg;                              // staged biases (float32)
  int ldy, ldvf, ldms;                          // float32 cotangents dY, dV, dM[:, s_in:]
  int w_bytes;                                  // one layer's staged weights (carve_weights)
};

// The tile in shared memory (rows r*3 + c per vector component c):
//   M  [R][ldm]  bf16   layer input scalars, then vnorm and scal9 appended;
//                       the running state in M[:, :s_out]
//   X  [3R][ldx] bf16   layer input vectors (the state in X[:, :v_out])
//   D  [3R][ldd] bf16   [vh | df]
//   S  [R][lds]  bf16   s_new;  G [R][ldv] bf16 gate logits;  U [3R][ldv] vh @ Wup
//   F  [R][12]   f32    frames
//   wso, wd, wup, wg    the layer's weights, bf16, zero-padded; bso, bg f32
// and for the backward:
//   dY [R][ldy] f32, dV [3R][ldvf] f32   cotangent of the state after the layer
//   dMs [R][ldms] f32   cotangent of vnorm and scal9
//   dS [R][lds] bf16, dD [3R][ldd] bf16;  dG over G, dU over U
struct Smem {
  bf16 *M, *X, *D, *S, *G, *U;
  float* F;
  char* wbase;  // the staged weights below, back to back (carve_weights)
  bf16 *wso, *wd, *wup, *wg;
  float *bso, *bg;
  float *dY, *dV, *dMs;
  bf16 *dS, *dD;
};

// A bump allocator over base (16-byte aligned); base == nullptr only
// measures.
struct Carver {
  char* base;
  size_t off = 0;
  template <typename T>
  __host__ __device__ T* take(size_t count) {
    T* p = base ? reinterpret_cast<T*>(base + off) : nullptr;
    off += (count * sizeof(T) + 15) & ~static_cast<size_t>(15);
    return p;
  }
};

// One layer's staged weights, back to back (the same layout in shared
// memory and in the per-layer images in global memory); returns the bytes.
__host__ __device__ inline size_t carve_weights(char* base, const Geom& g, Smem* s) {
  Carver c{base};
  s->wso = c.take<bf16>(static_cast<size_t>(g.r_wso) * g.ld_wso + 8);
  s->wd = c.take<bf16>(static_cast<size_t>(g.r_wd) * g.ld_wd);
  s->wup = c.take<bf16>(static_cast<size_t>(g.r_wup) * g.ld_wup);
  s->wg = c.take<bf16>(static_cast<size_t>(g.r_wg) * g.ld_wg);
  s->bso = c.take<float>(g.n_bso);
  s->bg = c.take<float>(g.n_bg);
  return c.off;
}

// Carves base into the arrays of s; returns the bytes used.
__host__ __device__ inline size_t carve(char* base, const Geom& g, Smem* s) {
  constexpr size_t R = kTile;
  Carver c{base};
  s->M = c.take<bf16>(R * g.ldm);
  s->X = c.take<bf16>(3 * R * g.ldx);
  s->D = c.take<bf16>(3 * R * g.ldd);
  s->S = c.take<bf16>(R * g.lds);
  s->G = c.take<bf16>(R * g.ldv);
  s->U = c.take<bf16>(3 * R * g.ldv);
  s->F = c.take<float>(R * kFrameLd);
  s->wbase = c.take<char>(g.w_bytes);
  carve_weights(s->wbase, g, s);
  s->dY = c.take<float>(R * g.ldy);
  s->dV = c.take<float>(3 * R * g.ldvf);
  s->dMs = c.take<float>(R * g.ldms);
  s->dS = c.take<bf16>(R * g.lds);
  s->dD = c.take<bf16>(3 * R * g.ldd);
  return c.off;
}

inline Geom geometry(const Stack& st) {
  Geom g{};
  int m = 0, x = 0, d = 0, s = 0, v = 0, y = 0, vf = 0, ms = 0;
  int wso_r = 0, wso_n = 0, wd_r = 0, wup_r = 0, wg_r = 0;
  for (int l = 0; l < st.n_layers; ++l) {
    const Layer& L = st.l[l];
    const int k = L.s_in + L.h + 9;
    m = std::max({m, pad16(k), L.s_out});
    x = std::max({x, pad16(L.v_in), pad16(L.v_out)});
    d = std::max(d, pad16(L.h + 3));
    s = std::max(s, pad16(L.s_out));
    v = std::max(v, pad16(L.v_out));
    y = std::max({y, L.s_out, l > 0 ? L.s_in : 0});
    vf = std::max({vf, L.v_out, l > 0 ? L.v_in : 0});
    ms = std::max(ms, L.h + 9);
    wso_r = std::max(wso_r, pad16(k));
    wso_n = std::max(wso_n, pad8(L.s_out));
    wd_r = std::max(wd_r, pad16(L.v_in));
    wup_r = std::max(wup_r, pad16(L.h));
    wg_r = std::max(wg_r, pad16(L.s_out));
  }
  g.ldm = ld_bf16(m);
  g.ldx = ld_bf16(x);
  g.ldd = ld_bf16(d);
  g.lds = ld_bf16(s);
  g.ldv = ld_bf16(v);
  // Wso^T is read with K = pad16(s_out) columns, up to 8 past ld_wso: the
  // next row's (finite) values, or the 8 zeros after the last row, meet
  // dS's zero padding columns
  g.ld_wso = ld_bf16(wso_n);
  g.r_wso = wso_r;
  g.ld_wd = ld_bf16(d);
  g.r_wd = wd_r;
  g.ld_wup = ld_bf16(v);
  g.r_wup = wup_r;
  g.ld_wg = ld_bf16(v);
  g.r_wg = wg_r;
  g.n_bso = wso_n;
  g.n_bg = v;
  g.ldy = y;
  g.ldvf = vf;
  g.ldms = ms;
  Smem w;
  g.w_bytes = static_cast<int>(carve_weights(nullptr, g, &w));
  return g;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  if constexpr (kTrans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
  }
}

template <bool kTrans>
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  if constexpr (kTrans) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_addr(p))
                 : "memory");
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_addr(p))
                 : "memory");
  }
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t relu2(uint32_t x) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x);
  v = __hmax2(v, __float2bfloat162_rn(0.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

// C(m, n) = init + sum_{k < Kp} A(m, k) B(k, n) for m < Mp (a multiple of
// 16), n < Np (a multiple of 8), on the tensor cores; the warps take 16 x 16
// blocks of C in turn.  A(m, k) = A[m * lda + k], or A[k * lda + m] when kAT;
// B(k, n) = B[k * ldb + n], or B[n * ldb + k] when kBT (a transposed
// operand is read with ldmatrix.trans or without, whichever gives the mma
// its fragment).  relu_a applies relu to A.  init(m, n, v0, v1) gives the
// starting values of C(m, n) and C(m, n + 1); epi(m, n, v0, v1) takes the
// results (n even, both pairs inside Np).  A warp calls init for its next
// block before the products of the current one, so that loads there (the
// weight-gradient partials, in global memory) overlap them.
template <bool kAT, bool kBT, typename Init, typename Epi>
__device__ __forceinline__ void gemm(const bf16* A, int lda, const bf16* B, int ldb, int Mp,
                                     int Np, int Kp, bool relu_a, Init init, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int li = lane >> 3, lr = lane & 7;  // the 8x8 matrix and the row this lane addresses
  const int nb = (Np + 15) >> 4;
  const int tasks = (Mp >> 4) * nb;
  // C's starting values for block t
  auto start = [&](int t, float (&c)[2][4]) {
    const int m0 = (t / nb) << 4, n0 = (t % nb) << 4;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j == 0 || n0 + 16 <= Np) {
        const int n = n0 + 8 * j + 2 * tig;
        init(m0 + gid, n, c[j][0], c[j][1]);
        init(m0 + gid + 8, n, c[j][2], c[j][3]);
      } else {
        c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
      }
    }
  };
  float next[2][4];
  if (warp < tasks) start(warp, next);
  for (int t = warp; t < tasks; t += kWarps) {
    const int m0 = (t / nb) << 4, n0 = (t % nb) << 4;
    const bool two = n0 + 16 <= Np;
    float c[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[j][i] = next[j][i];
    if (t + kWarps < tasks) start(t + kWarps, next);
    // this lane's row address in A's and in B's 8x8 matrices, at k = 0
    const bf16* pa = kAT ? A + (((li >> 1) << 3) + lr) * lda + m0 + ((li & 1) << 3)
                         : A + (m0 + (lane & 15)) * lda + ((lane >> 4) << 3);
    const bf16* pb = kBT ? B + (n0 + ((li >> 1) << 3) + lr) * ldb + ((li & 1) << 3)
                         : B + (((li & 1) << 3) + lr) * ldb + n0 + ((li >> 1) << 3);
    const int a_step = kAT ? 16 * lda : 16, b_step = kBT ? 16 : 16 * ldb;
    for (int k0 = 0; k0 < Kp; k0 += 16, pa += a_step, pb += b_step) {
      uint32_t a[4];
      ldsm_x4<kAT>(a, pa);
      if (relu_a) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = relu2(a[i]);
      }
      if (two) {
        uint32_t b[4];
        ldsm_x4<!kBT>(b, pb);
        mma16816(c[0], a, b[0], b[1]);
        mma16816(c[1], a, b[2], b[3]);
      } else {
        uint32_t b[2];
        ldsm_x2<!kBT>(b, pb);
        mma16816(c[0], a, b[0], b[1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j == 0 || two) {
        const int n = n0 + 8 * j + 2 * tig;
        epi(m0 + gid, n, c[j][0], c[j][1]);
        epi(m0 + gid + 8, n, c[j][2], c[j][3]);
      }
    }
  }
}

// gemm's init for a product that starts at 0
struct ZeroInit {
  __device__ __forceinline__ void operator()(int, int, float& v0, float& v1) const { v0 = v1 = 0.f; }
};

// p[0], p[1] = v0, v1 rounded to bf16, for the columns n, n + 1 below N
__device__ __forceinline__ void put2(bf16* p, int n, int N, float v0, float v1) {
  if (n + 1 < N) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else if (n < N) {
    p[0] = __float2bfloat16_rn(v0);
  }
}

__device__ __forceinline__ float f(bf16 x) { return __bfloat162float(x); }

// src [K][N] float32 into dst [rows][ld] as bf16, zeros outside [K][N]
__device__ inline void stage(bf16* dst, int ld, int len, const float* __restrict__ src, int K,
                             int N) {
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const int k = i / ld, n = i - k * ld;
    dst[i] = __float2bfloat16_rn(k < K && n < N ? __ldg(src + k * N + n) : 0.f);
  }
}

// Layer L's weights, bf16 and zero-padded, into the arrays of w (a layer's
// image in global memory; zeros for an absent gate).
__device__ inline void stage_weights(const Smem& w, const Geom& g, const Layer& L,
                                     const float* __restrict__ W) {
  const int gate_rows = L.vgate ? L.s_out : 0;
  stage(w.wso, g.ld_wso, g.r_wso * g.ld_wso + 8, W + L.off_wso, L.s_in + L.h + 9, L.s_out);
  stage(w.wd, g.ld_wd, g.r_wd * g.ld_wd, W + L.off_wd, L.v_in, L.h + 3);
  stage(w.wup, g.ld_wup, g.r_wup * g.ld_wup, W + L.off_wup, L.h, L.v_out);
  stage(w.wg, g.ld_wg, g.r_wg * g.ld_wg, W + L.off_wg, gate_rows, L.v_out);
  for (int i = threadIdx.x; i < g.n_bso; i += kThreads)
    w.bso[i] = i < L.s_out ? __ldg(W + L.off_bso + i) : 0.f;
  for (int i = threadIdx.x; i < g.n_bg; i += kThreads)
    w.bg[i] = i < L.v_out && L.vgate ? __ldg(W + L.off_bg + i) : 0.f;
}

// A layer's image (g.w_bytes, 16-byte aligned) into the tile's weights, by
// asynchronous 16-byte copies; the caller synchronises the block after.
__device__ inline void load_weights(const Smem& s, const Geom& g, const char* __restrict__ image) {
  for (int i = threadIdx.x * 16; i < g.w_bytes; i += kThreads * 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(s.wbase + i)),
                 "l"(image + i));
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The stack's input rows (bf16) into M and X; rows past the end are zeros.
__device__ inline void load_input(const Smem& s, const Geom& g, const Layer& L,
                                  const bf16* __restrict__ msg, int rows) {
  const int in_dim = L.s_in + 3 * L.v_in;
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < kTile * in_dim; i += kThreads) {
    const int r = i / in_dim, col = i - r * in_dim;
    const bf16 x = r < rows ? msg[i] : zero;
    if (col < L.s_in) {
      s.M[r * g.ldm + col] = x;
    } else {
      const int j = col - L.s_in, c = j / L.v_in;
      s.X[(r * 3 + c) * g.ldx + (j - c * L.v_in)] = x;
    }
  }
}

// Layer L's intermediates D, M[:, s_in:], S, U and G from its input state
// in M[:, :s_in] and X, with its weights staged.
__device__ inline void layer_forward(const Smem& s, const Geom& g, const Layer& L) {
  const int h = L.h, hk = h + 9;
  constexpr int R = kTile;
  // D = X @ [Wd | Wdf]
  gemm<false, false>(s.X, g.ldx, s.wd, g.ld_wd, 3 * R, pad8(h + 3), pad16(L.v_in), false, ZeroInit{},
                     [&](int m, int n, float v0, float v1) { put2(s.D + m * g.ldd + n, n, h + 3, v0, v1); });
  __syncthreads();
  // vnorm and scal9
  for (int i = threadIdx.x; i < R * hk; i += kThreads) {
    const int r = i / hk, j = i - r * hk;
    const bf16* d = s.D + r * 3 * g.ldd;
    float val;
    if (j < h) {
      const float x = f(d[j]), y = f(d[g.ldd + j]), z = f(d[2 * g.ldd + j]);
      val = sqrtf(x * x + y * y + z * z + kEps) + kEps;
    } else {
      const int q = j - h, ch = q / 3, fi = q - 3 * ch;
      const float* fr = s.F + r * kFrameLd + 3 * fi;
      val = f(d[h + ch]) * fr[0] + f(d[g.ldd + h + ch]) * fr[1] + f(d[2 * g.ldd + h + ch]) * fr[2];
    }
    s.M[r * g.ldm + L.s_in + j] = __float2bfloat16_rn(val);
  }
  __syncthreads();
  // S = [s | vnorm | scal9] @ Wso + bso;  U = vh @ Wup
  gemm<false, false>(s.M, g.ldm, s.wso, g.ld_wso, R, pad8(L.s_out), pad16(L.s_in + hk), false,
                     ZeroInit{}, [&](int m, int n, float v0, float v1) {
                       put2(s.S + m * g.lds + n, n, L.s_out, v0 + s.bso[n], v1 + s.bso[n + 1]);
                     });
  gemm<false, false>(s.D, g.ldd, s.wup, g.ld_wup, 3 * R, pad8(L.v_out), pad16(h), false, ZeroInit{},
                     [&](int m, int n, float v0, float v1) { put2(s.U + m * g.ldv + n, n, L.v_out, v0, v1); });
  __syncthreads();
  if (L.vgate) {
    // G = act_v(S) @ Wg + bg
    gemm<false, false>(s.S, g.lds, s.wg, g.ld_wg, R, pad8(L.v_out), pad16(L.s_out), L.act_v == 1,
                       ZeroInit{}, [&](int m, int n, float v0, float v1) {
                         put2(s.G + m * g.ldv + n, n, L.v_out, v0 + s.bg[n], v1 + s.bg[n + 1]);
                       });
    __syncthreads();
  }
}

// Layer L's output written over (ResGCP: added to) the state in M and X,
// rounded to bf16, and, unless slot is null, copied to slot ([R][s_out]
// scalars, then [3R][v_out] vectors).
__device__ inline void layer_output(const Smem& s, const Geom& g, const Layer& L, bool add,
                                    bf16* slot) {
  constexpr int R = kTile;
  bf16* slot_v = slot ? slot + R * L.s_out : nullptr;
  for (int i = threadIdx.x; i < R * L.v_out; i += kThreads) {
    const int r = i / L.v_out, o = i - r * L.v_out;
    float u[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      u[c] = f(s.U[(r * 3 + c) * g.ldv + o]) + (L.vres ? f(s.X[(r * 3 + c) * g.ldx + o]) : 0.f);
    float gt = 1.f;
    if (L.vgate) {
      gt = 1.f / (1.f + expf(-f(s.G[r * g.ldv + o])));
    } else if (L.act_v) {
      gt = act(sqrtf(u[0] * u[0] + u[1] * u[1] + u[2] * u[2] + kEps) + kEps, L.act_v);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      bf16* x = s.X + (r * 3 + c) * g.ldx + o;
      *x = __float2bfloat16_rn((add ? f(*x) : 0.f) + u[c] * gt);
      if (slot) slot_v[(r * 3 + c) * L.v_out + o] = *x;
    }
  }
  for (int i = threadIdx.x; i < R * L.s_out; i += kThreads) {
    const int r = i / L.s_out, o = i - r * L.s_out;
    bf16* m = s.M + r * g.ldm + o;
    *m = __float2bfloat16_rn((add ? f(*m) : 0.f) + act(f(s.S[r * g.lds + o]), L.act_s));
    if (slot) slot[r * L.s_out + o] = *m;
  }
  __syncthreads();
}

}  // namespace tc
}  // namespace gcp
