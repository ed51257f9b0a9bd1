// The message stack's layer body on the tensor cores, in two operand types,
// used by K2 (edge_map_tc.cu) and by K3 (edge_map_bwd_tc.cu), both in bf16
// and in float32: a tile of edge rows in shared memory, each layer's
// weights staged beside it, and every product a warp-level mma.sync.
//
// bf16 (T = bf16): mma.sync m16n8k16, bf16 operands, float32 accumulators,
// each product's output rounded to bf16 where it is stored: the JAX
// kernel's numerics (gcpnet_tpu/ops/pallas_fused.py:87-89, 103-105 with
// gcp._mm).  K2 and K3 run the same functions here, so K3's recompute
// rebuilds exactly the state K2 computed, in either type.
//
// float32 (T = float): split TF32 ("3xTF32"): each operand x becomes
// hi = tf32(x) and lo = tf32(x - hi), and each product is
// lo*hi + hi*lo + hi*hi on mma.sync m16n8k8 .tf32 with float32
// accumulators, one for each of the three, added at the end; what it drops
// (lo*lo, ~2^-22 relative) is below float32's own rounding of the sums.
// The weights are staged transposed ([n][k]), as ldmatrix moves 16-bit
// pairs and cannot transpose 32-bit values; the operands ldmatrix cannot
// deliver (the backward's weights, and the weight gradients' operands,
// read across their rows) are read by each lane as its own 32-bit fragment
// values (gemm).
//
// In both: norms, square roots, sigmoids, activations and the frame
// contractions in float32 registers.  The layer table is edge_stack.cuh's.
//
// The tile height R (edge rows, a multiple of 16) is a template parameter
// of the body: K2 and the bf16 K3 take kTile, the float32 K3 half as many
// (its tile and cotangents take ~3.9 KB a row in float32, ~2.5 KB in bf16).
//
// Padding: a product runs on M, N and K rounded up to the mma shape (M to
// 16, N to 8, K to 16 bf16 or 8 float32 values: 32 bytes).  The weights are
// staged with zeros in their padding rows and columns, and every activation
// array starts zeroed and is written only in its real columns, so the
// padding of one operand meets zeros or finite values in the other and adds
// nothing; results are stored for the real rows and columns only.
#pragma once

#include <cstdint>

#include "edge_stack.cuh"

namespace gcp {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;     // edge rows per tile of K2 and the bf16 K3
constexpr int kThreads = 512;  // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // bytes a block may use on the H100
constexpr int kChunkK = 128;      // float32 Wso: K columns staged at a time
static_assert(kTile % 16 == 0 && kThreads % 32 == 0, "tile rows: a multiple of 16");

// float32 weights are staged transposed
template <typename T>
constexpr bool kWeightsT = sizeof(T) == 4;

__host__ __device__ inline int pad8(int x) { return (x + 7) & ~7; }
__host__ __device__ inline int pad16(int x) { return (x + 15) & ~15; }
// K rounded up to the mma's depth: 32 bytes of T
template <typename T>
__host__ __device__ inline int padk(int x) {
  constexpr int k = 32 / sizeof(T);
  return (x + k - 1) / k * k;
}
// A row stride of at least x elements of T whose count of 16-byte units is
// odd, so that the eight rows one ldmatrix reads fall on distinct banks.
template <typename T>
__host__ __device__ inline int ld_of(int x) {
  constexpr int u = 16 / sizeof(T);
  const int l = (x + u - 1) / u * u;
  return ((l / u) & 1) ? l : l + u;
}

// Row strides (elements of T) and staged-weight shapes, the same for every
// layer: each is the largest any layer needs.
struct Geom {
  int ldm, ldx, ldd, lds, ldv;  // tile: M, X, D (dD), S (dS), G U (dG dU)
  // staged weights, r_* rows of ld_* elements: [k][n] in bf16, [n][k] in
  // float32; Wso in chunks of wso_k K columns (float32; bf16: one chunk)
  int ld_wso, r_wso, ld_wd, r_wd, ld_wup, r_wup, ld_wg, r_wg;
  int n_bso, n_bg;              // staged biases (float32)
  int ldy, ldvf, ldms;          // float32 cotangents dY, dV, dM[:, s_in:] (K3)
  int wso_k, wso_bytes;         // K columns and bytes of one Wso chunk
  int w_off_wso;                // bytes before Wso in a layer's weights
  int w_bytes;                  // one layer's weights in shared memory (one Wso chunk)
  int img_bytes;                // one layer's image in global memory (every chunk)
};

// The tile in shared memory (rows r*3 + c per vector component c):
//   M  [R][ldm]  T    layer input scalars, then vnorm and scal9 appended;
//                     the running state in M[:, :s_out]
//   X  [3R][ldx] T    layer input vectors (the state in X[:, :v_out])
//   D  [3R][ldd] T    [vh | df]
//   S  [R][lds]  T    s_new;  G [R][ldv] T gate logits;  U [3R][ldv] vh @ Wup
//   F  [R][12]   f32  frames
//   wd, wup, wg, bso, bg, wso   the layer's weights, zero-padded (biases f32)
// and for the backward (K3):
//   dY [R][ldy] f32, dV [3R][ldvf] f32   cotangent of the state after the layer
//   dMs [R][ldms] f32   cotangent of vnorm and scal9
//   dS [R][lds] T, dD [3R][ldd] T;  dG over G, dU over U
template <typename T>
struct Smem {
  T *M, *X, *D, *S, *G, *U;
  float* F;
  char* wbase;  // the weight buffer(s) (carve_weights)
  T *wd, *wup, *wg, *wso;
  float *bso, *bg;
  float *dY, *dV, *dMs;
  T *dS, *dD;
};

// A bump allocator over base (16-byte aligned); base == nullptr only
// measures.
struct Carver {
  char* base;
  size_t off = 0;
  template <typename U>
  __host__ __device__ U* take(size_t count) {
    U* p = base ? reinterpret_cast<U*>(base + off) : nullptr;
    off += (count * sizeof(U) + 15) & ~static_cast<size_t>(15);
    return p;
  }
};

// One layer's staged weights, back to back, Wso last (the same layout in
// shared memory and in the per-layer images in global memory, where the
// further Wso chunks follow the first); returns the bytes before Wso.
template <typename T>
__host__ __device__ inline size_t carve_weights(char* base, const Geom& g, Smem<T>* s) {
  Carver c{base};
  s->wd = c.take<T>(static_cast<size_t>(g.r_wd) * g.ld_wd);
  s->wup = c.take<T>(static_cast<size_t>(g.r_wup) * g.ld_wup);
  s->wg = c.take<T>(static_cast<size_t>(g.r_wg) * g.ld_wg);
  s->bso = c.take<float>(g.n_bso);
  s->bg = c.take<float>(g.n_bg);
  s->wso = c.take<T>(0);
  return c.off;
}

// Carves base into the arrays of s for a tile of R rows with nbuf weight
// buffers (s->wbase is the first); without the backward's arrays G shares
// D's space (D is dead once U is computed, G is written after).  Returns
// the bytes used.
template <typename T, int R>
__host__ __device__ inline size_t carve(char* base, const Geom& g, Smem<T>* s, int nbuf, bool backward) {
  Carver c{base};
  s->M = c.take<T>(R * g.ldm);
  s->X = c.take<T>(3 * R * g.ldx);
  if (backward) {
    s->D = c.take<T>(3 * R * g.ldd);
    s->G = c.take<T>(R * g.ldv);
  } else {
    s->D = s->G = c.take<T>(3 * g.ldd >= g.ldv ? 3 * R * g.ldd : R * g.ldv);
  }
  s->S = c.take<T>(R * g.lds);
  s->U = c.take<T>(3 * R * g.ldv);
  s->F = c.take<float>(R * kFrameLd);
  s->wbase = c.take<char>(static_cast<size_t>(nbuf) * g.w_bytes);
  carve_weights(s->wbase, g, s);
  if (backward) {
    s->dY = c.take<float>(R * g.ldy);
    s->dV = c.take<float>(3 * R * g.ldvf);
    s->dMs = c.take<float>(R * g.ldms);
    s->dS = c.take<T>(R * g.lds);
    s->dD = c.take<T>(3 * R * g.ldd);
  }
  return c.off;
}

template <typename T>
inline Geom geometry(const Stack& st) {
  Geom g{};
  int m = 0, x = 0, d = 0, s = 0, v = 0, y = 0, vf = 0, ms = 0;
  int k_max = 0, n_so = 0, n_v = 0, h_max = 0, vin_max = 0, d_n = 0, s_k = 0;
  for (int l = 0; l < st.n_layers; ++l) {
    const Layer& L = st.l[l];
    const int k = padk<T>(L.s_in + L.h + 9);
    m = std::max({m, k, L.s_out});
    x = std::max({x, padk<T>(L.v_in), padk<T>(L.v_out)});
    d = std::max(d, padk<T>(L.h + 3));
    s = std::max(s, padk<T>(L.s_out));
    v = std::max(v, padk<T>(L.v_out));
    y = std::max({y, L.s_out, l > 0 ? L.s_in : 0});
    vf = std::max({vf, L.v_out, l > 0 ? L.v_in : 0});
    ms = std::max(ms, L.h + 9);
    k_max = std::max(k_max, k);
    n_so = std::max(n_so, pad8(L.s_out));
    n_v = std::max(n_v, pad8(L.v_out));
    h_max = std::max(h_max, padk<T>(L.h));
    vin_max = std::max(vin_max, padk<T>(L.v_in));
    d_n = std::max(d_n, pad8(L.h + 3));
    s_k = std::max(s_k, padk<T>(L.s_out));
  }
  g.ldm = ld_of<T>(m);
  g.ldx = ld_of<T>(x);
  g.ldd = ld_of<T>(d);
  g.lds = ld_of<T>(s);
  g.ldv = ld_of<T>(v);
  g.ldy = y;
  g.ldvf = vf;
  g.ldms = ms;
  if (kWeightsT<T>) {
    // [n][k]: rows are the output columns, padded to the mma's 8
    g.wso_k = std::min(k_max, kChunkK);
    g.r_wso = n_so;
    g.ld_wso = ld_of<T>(g.wso_k);
    g.wso_bytes = pad16(g.r_wso * g.ld_wso * static_cast<int>(sizeof(T)));
    g.r_wd = d_n;
    g.ld_wd = ld_of<T>(vin_max);
    g.r_wup = n_v;
    g.ld_wup = ld_of<T>(h_max);
    g.r_wg = n_v;
    g.ld_wg = ld_of<T>(s_k);
    g.n_bg = n_v;
  } else {
    // [k][n]; the bf16 K3 also reads Wso^T with K = pad16(s_out) columns,
    // up to 8 past ld_wso: the next row's (finite) values, or the 8 zeros
    // after the last row, meet dS's zero padding columns
    g.wso_k = k_max;
    g.r_wso = k_max;
    g.ld_wso = ld_of<T>(n_so);
    g.wso_bytes = pad16((g.r_wso * g.ld_wso + 8) * static_cast<int>(sizeof(T)));
    g.r_wd = vin_max;
    g.ld_wd = ld_of<T>(d);
    g.r_wup = h_max;
    g.ld_wup = ld_of<T>(v);
    g.r_wg = s_k;
    g.ld_wg = ld_of<T>(v);
    g.n_bg = v;
  }
  g.n_bso = n_so;
  Smem<T> w;
  g.w_off_wso = static_cast<int>(carve_weights<T>(nullptr, g, &w));
  g.w_bytes = g.w_off_wso + g.wso_bytes;
  g.img_bytes = g.w_off_wso + (k_max + g.wso_k - 1) / g.wso_k * g.wso_bytes;
  return g;
}

// Wso chunks of a layer whose K is k_pad
__host__ __device__ inline int wso_chunks(const Geom& g, int k_pad) { return (k_pad + g.wso_k - 1) / g.wso_k; }

// Bytes of layer L's first Wso chunk that its products read (bf16: the rows
// up to pad16(K), and the 8 values after them that K3's transposed read
// may touch).
template <typename T>
__host__ __device__ inline int wso_first_bytes(const Geom& g, const Layer& L) {
  if (kWeightsT<T>) return g.wso_bytes;
  return pad16((padk<T>(L.s_in + L.h + 9) * g.ld_wso + 8) * static_cast<int>(sizeof(T)));
}

// Bytes of layer L's image that go to shared memory before its products:
// the small weights and biases and the first Wso chunk, as far as it is
// read.
template <typename T>
__host__ __device__ inline int layer_bytes(const Geom& g, const Layer& L) {
  return g.w_off_wso + wso_first_bytes<T>(g, L);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
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
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
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

__device__ __forceinline__ void mma1688_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An activation a product applies to its A operand (gemm's kActA): a layer
// table code (1 relu, 2 leaky relu, 3 silu) and leaky relu's slope.  kActA
// is 0 (none), 1 (relu or leaky relu) or 2 (silu too).
struct Act {
  int code;
  float slope;
};

// The activation a of one A-operand word: a bf16 pair, or a float32 value
// (its bits).  A NaN stays a NaN.  relu of a bf16 pair is exact in bf16;
// leaky relu and silu (kSilu) are taken in float32 and rounded to bf16, as
// the plain version computes them (a bf16 multiply by a bf16 slope would
// round twice differently).
template <typename T, bool kSilu>
__device__ __forceinline__ uint32_t act_word(uint32_t x, Act a) {
  if constexpr (sizeof(T) == 4) {
    const float v = __uint_as_float(x);
    if constexpr (kSilu) {
      if (a.code == 3) return __float_as_uint(silu(v));
    }
    return __float_as_uint(a.code == 1 ? relu(v) : leaky_relu(v, a.slope));
  } else {
    __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x);
    if (a.code == 1) {
      v = __hmax2_nan(v, __float2bfloat162_rn(0.f));
    } else {
      const float2 p = __bfloat1622float2(v);
      if (kSilu && a.code == 3) {
        v = __floats2bfloat162_rn(silu(p.x), silu(p.y));
      } else {
        v = __floats2bfloat162_rn(leaky_relu(p.x, a.slope), leaky_relu(p.y, a.slope));
      }
    }
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// x (float32 bits) rounded to TF32 (10 mantissa bits, the low 13 bits
// zero), to nearest with ties away from zero: cvt.rna.tf32.f32's result for
// every x but a NaN, in two integer instructions where cvt compiles to four
// or more; the splits, not the mma, take most of a float32 product's issue
// slots.  A NaN's mantissa can carry into its exponent and sign here
// (0x7fffffff becomes -0): split_tf32 keeps NaNs out.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t x) { return (x + 0x1000u) & 0xffffe000u; }

// x (float32 bits) as hi = tf32(x) and lo = tf32(x - hi).  hi is
// tf32_rna(x) + x * 0, one FFMA: that adds an exact zero of x's sign to a
// finite x's rounding (the same bits), and makes hi the canonical NaN
// 0x7fffffff (a NaN with or without its low 13 bits) for a NaN or infinite
// x, so every product such an x enters is a NaN (for a NaN, as in float32;
// for an infinity, as with cvt.rna, whose lo is a NaN).  A select on
// x != x does the same in two instructions and made K3 fp32 4% slower.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  const float v = __uint_as_float(x);
  hi = __float_as_uint(__fmaf_rn(v, 0.f, __uint_as_float(tf32_rna(x))));
  lo = tf32_rna(__float_as_uint(v - __uint_as_float(hi)));
}

// One k step's A fragment as the mma takes it, and the mma with a B
// fragment (b0, b1 as ldmatrix gave them) into the accumulators c, and for
// float32 also lo and hi, which take the two small products: three chains
// of mmas that do not wait on each other, added at the end (sum).
template <typename T>
struct AFrag;

template <>
struct AFrag<bf16> {
  uint32_t r[4];
  __device__ __forceinline__ explicit AFrag(const uint32_t (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = a[i];
  }
  __device__ __forceinline__ void mma(float (&c)[4], float (&)[4], float (&)[4], uint32_t b0, uint32_t b1) const {
    mma16816(c, r, b0, b1);
  }
  __device__ __forceinline__ static void sum(float (&)[4], const float (&)[4], const float (&)[4]) {}
};

template <>
struct AFrag<float> {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit AFrag(const uint32_t (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], hi[i], lo[i]);
  }
  __device__ __forceinline__ void mma(float (&c)[4], float (&c_lo)[4], float (&c_hi)[4], uint32_t b0,
                                      uint32_t b1) const {
    uint32_t h0, l0, h1, l1;
    split_tf32(b0, h0, l0);
    split_tf32(b1, h1, l1);
    mma1688_tf32(c_lo, lo, h0, h1);
    mma1688_tf32(c_hi, hi, l0, l1);
    mma1688_tf32(c, hi, h0, h1);
  }
  // the small products' sums, then the large one's
  __device__ __forceinline__ static void sum(float (&c)[4], const float (&c_lo)[4], const float (&c_hi)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += c_lo[i] + c_hi[i];
  }
};

// C(m, n) = init + sum_{k < Kp} A(m, k) B(k, n) for m < Mp (a multiple of
// 16), n < Np (a multiple of 8), Kp a multiple of padk<T>'s step, on the
// tensor cores; the warps take 16 x 16 blocks of C in turn.  A(m, k) =
// A[m * lda + k], or A[k * lda + m] when kAT; B(k, n) = B[k * ldb + n], or
// B[n * ldb + k] when kBT.  bf16 operands are read with ldmatrix (.trans
// or not, whichever gives the mma its fragment).  float32 operands are read
// with ldmatrix where it gives the fragment (A row-major, B transposed);
// otherwise each lane loads its own values, one 32-bit word each: an
// m16n8k8 .tf32 fragment holds A(gid, k), A(gid + 8, k) and B(k, gid) at
// the mma's k slots tig and tig + 4 (gid = lane / 4, tig = lane % 4).
// When both are loaded so, a lane takes k = 2 tig and 2 tig + 1 into those
// slots (any order of k both operands agree on gives the same sum): rows
// 0, 2, 4, 6 (and 1, 3, 5, 7) of a stride that is an odd multiple of 4
// words fall on distinct banks, so the weight gradients' reads, across the
// tile's rows, are free of bank conflicts.  With kActA, A goes through the
// activation act_a before the product (and before float32's split); the
// products without it are compiled apart, so they pay nothing for it.
// init(m, n, v0, v1) gives the starting values of C(m, n) and C(m, n + 1);
// epi(m, n, v0, v1) takes the results (n even, both pairs inside Np).  A
// warp calls init for its next block before the products of the current
// one, so that loads there (the weight-gradient partials, in global memory)
// overlap them.  The ldmatrix lane addresses are the same in bytes for both
// types: a k step is 32 bytes, an 8x8 ldmatrix tile 16 bytes a row.
template <typename T, bool kAT, bool kBT, int kActA = 0, typename Init, typename Epi>
__device__ __forceinline__ void gemm(const T* A, int lda, const T* B, int ldb, int Mp, int Np, int Kp,
                                     Act act_a, Init init, Epi epi) {
  constexpr bool kWordA = sizeof(T) == 4 && kAT;   // A loaded a word a lane
  constexpr bool kWordB = sizeof(T) == 4 && !kBT;  // B loaded a word a lane
  constexpr bool kPairK = kWordA && kWordB;        // k = 2 tig, 2 tig + 1
  constexpr int kU = 16 / sizeof(T);  // elements in 16 bytes
  constexpr int kK = 2 * kU;          // k of one mma step
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int li = lane >> 3, lr = lane & 7;  // the 8x8 matrix and the row this lane addresses
  // the k of this lane's first fragment value, and how far the second lies
  const int k_lane = kPairK ? 2 * tig : tig, k_gap = kPairK ? 1 : 4;
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
    // this lane's address in A and in B at k = 0: its row of an 8x8
    // ldmatrix tile, or its first fragment value
    const T* pa = kWordA ? A + k_lane * lda + m0 + gid
                  : kAT  ? A + (((li >> 1) << 3) + lr) * lda + m0 + ((li & 1) << 3)
                         : A + (m0 + (lane & 15)) * lda + (lane >> 4) * kU;
    const T* pb = kWordB ? B + k_lane * ldb + n0 + gid
                  : kBT  ? B + (n0 + ((li >> 1) << 3) + lr) * ldb + (li & 1) * kU
                         : B + (((li & 1) << 3) + lr) * ldb + n0 + ((li >> 1) << 3);
    const int a_step = kAT ? kK * lda : kK, b_step = kBT ? kK : kK * ldb;
    float c_lo[2][4] = {}, c_hi[2][4] = {};  // float32's small products
    for (int k0 = 0; k0 < Kp; k0 += kK, pa += a_step, pb += b_step) {
      uint32_t a[4];
      if constexpr (kWordA) {
        const int gap = k_gap * lda;
        a[0] = __float_as_uint(pa[0]);
        a[1] = __float_as_uint(pa[8]);
        a[2] = __float_as_uint(pa[gap]);
        a[3] = __float_as_uint(pa[gap + 8]);
      } else {
        ldsm_x4<kAT>(a, pa);
      }
      if constexpr (kActA != 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = act_word<T, kActA == 2>(a[i], act_a);
      }
      const AFrag<T> af(a);
      if (two) {
        uint32_t b[4];
        if constexpr (kWordB) {
          const int gap = k_gap * ldb;
          b[0] = __float_as_uint(pb[0]);
          b[1] = __float_as_uint(pb[gap]);
          b[2] = __float_as_uint(pb[8]);
          b[3] = __float_as_uint(pb[gap + 8]);
        } else {
          ldsm_x4<!kBT>(b, pb);
        }
        af.mma(c[0], c_lo[0], c_hi[0], b[0], b[1]);
        af.mma(c[1], c_lo[1], c_hi[1], b[2], b[3]);
      } else {
        uint32_t b[2];
        if constexpr (kWordB) {
          b[0] = __float_as_uint(pb[0]);
          b[1] = __float_as_uint(pb[k_gap * ldb]);
        } else {
          ldsm_x2<!kBT>(b, pb);
        }
        af.mma(c[0], c_lo[0], c_hi[0], b[0], b[1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) AFrag<T>::sum(c[j], c_lo[j], c_hi[j]);
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

// p[0], p[1] = v0, v1 (rounded to bf16), for the columns n, n + 1 below N
__device__ __forceinline__ void put2(bf16* p, int n, int N, float v0, float v1) {
  if (n + 1 < N) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else if (n < N) {
    p[0] = __float2bfloat16_rn(v0);
  }
}
__device__ __forceinline__ void put2(float* p, int n, int N, float v0, float v1) {
  if (n + 1 < N) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else if (n < N) {
    p[0] = v0;
  }
}

__device__ __forceinline__ float f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float f(float x) { return x; }

// dst[a * ld + b] for i = a * ld + b < len, as T: src(k, n) of a row-major
// float32 [K][N], with (k, n) = (a, b), or, when trans, (k0 + b, a) for
// b < kw (columns k0 .. k0 + kw of the transpose); zeros elsewhere.
template <typename T>
__device__ inline void stage(T* dst, int ld, int len, const float* __restrict__ src, int K, int N,
                             bool trans, int k0 = 0, int kw = 1 << 30) {
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const int a = i / ld, b = i - a * ld;
    const int k = trans ? k0 + b : a, n = trans ? a : b;
    const bool in = k < K && n < N && (!trans || b < kw);
    store_f(dst + i, in ? __ldg(src + k * N + n) : 0.f);
  }
}

// Layer L's weights W (float32), by the block, as the image load_weights
// copies into shared memory: as T, zero-padded (zeros for an absent gate),
// Wso's chunks one after another.  Each kernel launches it from a kernel of
// its own name (one block a layer, image l at l * g.img_bytes).
template <typename T>
__device__ inline void build_image(const float* __restrict__ W, const Layer& L, const Geom& g, char* image) {
  constexpr bool t = kWeightsT<T>;
  Smem<T> w;
  carve_weights(image, g, &w);
  const int gate_rows = L.vgate ? L.s_out : 0;
  stage(w.wd, g.ld_wd, g.r_wd * g.ld_wd, W + L.off_wd, L.v_in, L.h + 3, t);
  stage(w.wup, g.ld_wup, g.r_wup * g.ld_wup, W + L.off_wup, L.h, L.v_out, t);
  stage(w.wg, g.ld_wg, g.r_wg * g.ld_wg, W + L.off_wg, gate_rows, L.v_out, t);
  for (int i = threadIdx.x; i < g.n_bso; i += kThreads) w.bso[i] = i < L.s_out ? __ldg(W + L.off_bso + i) : 0.f;
  for (int i = threadIdx.x; i < g.n_bg; i += kThreads)
    w.bg[i] = i < L.v_out && L.vgate ? __ldg(W + L.off_bg + i) : 0.f;
  const int chunks = (g.img_bytes - g.w_off_wso) / g.wso_bytes;
  for (int c = 0; c < chunks; ++c)
    stage(reinterpret_cast<T*>(image + g.w_off_wso + c * g.wso_bytes), g.ld_wso,
          g.wso_bytes / static_cast<int>(sizeof(T)), W + L.off_wso, L.s_in + L.h + 9, L.s_out, t,
          c * g.wso_k, g.wso_k);
}

// bytes (a multiple of 16) from src in global memory to dst in shared
// memory by asynchronous 16-byte copies, as one group; wait with
// cp_async_wait and synchronise the block before reading them.
__device__ inline void copy_async(char* dst, const char* __restrict__ src, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += kThreads * 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst + i)), "l"(src + i));
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Layer L's image into the weight buffer s.wbase (its first Wso chunk, as
// far as it is read) and wait for it; the caller synchronises the block.
template <typename T>
__device__ inline void load_weights(const Smem<T>& s, const Geom& g, const Layer& L, const char* __restrict__ image) {
  copy_async(s.wbase, image, layer_bytes<T>(g, L));
  cp_async_wait();
}

// put(r, col, x) for every element x of the tile's rows r < R of a
// row-major [*, width] array whose row 0 is src (x = 0 for r >= rows), read
// as 16-byte vectors where src is 16-byte aligned (R * width elements are a
// whole number of them).
template <int R, typename T, typename Put>
__device__ inline void load_rows(const T* __restrict__ src, int width, int rows, Put put) {
  constexpr int u = 16 / sizeof(T);
  const int n = rows * width, total = R * width;
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int i = threadIdx.x; i * u < total; i += kThreads) {
    const int e = i * u;
    alignas(16) T v[u];
    if (vec && e + u <= n) {
      *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(src) + i);
    } else {
#pragma unroll
      for (int j = 0; j < u; ++j) store_f(v + j, e + j < n ? f(src[e + j]) : 0.f);
    }
    int r = e / width, col = e - r * width;
#pragma unroll
    for (int j = 0; j < u; ++j) {
      if (e + j < total) put(r, col, v[j]);
      if (++col == width) col = 0, ++r;
    }
  }
}

// The stack's input rows into M and X and their frames into F; rows past
// the end are zeros.
template <typename T, int R>
__device__ inline void load_input(const Smem<T>& s, const Geom& g, const Layer& L, const T* __restrict__ msg,
                                  const T* __restrict__ frames, int rows) {
  load_rows<R>(msg, L.s_in + 3 * L.v_in, rows, [&](int r, int col, T x) {
    if (col < L.s_in) {
      s.M[r * g.ldm + col] = x;
    } else {
      const int j = col - L.s_in, c = j / L.v_in;
      s.X[(r * 3 + c) * g.ldx + (j - c * L.v_in)] = x;
    }
  });
  if (frames) load_rows<R>(frames, 9, rows, [&](int r, int col, T x) { s.F[r * kFrameLd + col] = f(x); });
}

// G = act_v(S) @ Wg + bg for layer L's vector gate (kActA: gemm's, 0 where
// act_v is the identity).
template <int kActA, typename T, int R>
__device__ __forceinline__ void gate_logits(const Smem<T>& s, const Geom& g, const Layer& L) {
  gemm<T, false, kWeightsT<T>, kActA>(s.S, g.lds, s.wg, g.ld_wg, R, pad8(L.v_out), padk<T>(L.s_out),
                                      Act{L.act_v, L.slope}, ZeroInit{}, [&](int m, int n, float v0, float v1) {
                                        put2(s.G + m * g.ldv + n, n, L.v_out, v0 + s.bg[n], v1 + s.bg[n + 1]);
                                      });
}

// Layer L's intermediates D, M[:, s_in:], S, U and G for a tile of R rows
// from its input state in M[:, :s_in] and X, with its weights in s.wd ...
// s.wso (the first Wso chunk; the further ones, for float32 layers with
// K > kChunkK, are copied here from the layer's image, and the last stays
// in s.wso).  wso_free() runs once Wso's buffer is no longer read (it may
// start copying the next layer's Wso there).  kSilu: the stack uses silu
// (edge_stack.cuh uses_silu).
template <typename T, int R, bool kSilu, typename Hook>
__device__ inline void layer_forward(const Smem<T>& s, const Geom& g, const Layer& L, const char* image,
                                     Hook wso_free) {
  constexpr bool kWT = kWeightsT<T>;
  const int h = L.h, hk = h + 9;
  // D = X @ [Wd | Wdf]
  if constexpr (kK2Products)
    gemm<T, false, kWT>(s.X, g.ldx, s.wd, g.ld_wd, 3 * R, pad8(h + 3), padk<T>(L.v_in), Act{}, ZeroInit{},
                      [&](int m, int n, float v0, float v1) { put2(s.D + m * g.ldd + n, n, h + 3, v0, v1); });
  __syncthreads();
  // vnorm and scal9
  for (int i = threadIdx.x; kK2Elementwise && i < R * hk; i += kThreads) {
    const int r = i / hk, j = i - r * hk;
    const T* d = s.D + r * 3 * g.ldd;
    float val;
    if (j < h) {
      const float x = f(d[j]), y = f(d[g.ldd + j]), z = f(d[2 * g.ldd + j]);
      val = sqrtf(x * x + y * y + z * z + kEps) + kEps;
    } else {
      const int q = j - h, ch = q / 3, fi = q - 3 * ch;
      const float* fr = s.F + r * kFrameLd + 3 * fi;
      val = f(d[h + ch]) * fr[0] + f(d[g.ldd + h + ch]) * fr[1] + f(d[2 * g.ldd + h + ch]) * fr[2];
    }
    store_f(s.M + r * g.ldm + L.s_in + j, val);
  }
  __syncthreads();
  // U = vh @ Wup
  if constexpr (kK2Products)
    gemm<T, false, kWT>(s.D, g.ldd, s.wup, g.ld_wup, 3 * R, pad8(L.v_out), padk<T>(h), Act{}, ZeroInit{},
                      [&](int m, int n, float v0, float v1) { put2(s.U + m * g.ldv + n, n, L.v_out, v0, v1); });
  // S = [s | vnorm | scal9] @ Wso + bso, over Wso's chunks (a float32
  // partial sum is kept in S between them, exactly)
  const int kp = padk<T>(L.s_in + hk), chunks = wso_chunks(g, kp);
  for (int c = 0; c < chunks; ++c) {
    if (c > 0) {
      __syncthreads();
      if constexpr (kK2Staging)
        copy_async(reinterpret_cast<char*>(s.wso), image + g.w_off_wso + c * g.wso_bytes, g.wso_bytes);
      cp_async_wait();
      __syncthreads();
    }
    const int k0 = c * g.wso_k;
    const bool last = c == chunks - 1;
    if constexpr (kK2Products)
      gemm<T, false, kWT>(
        s.M + k0, g.ldm, s.wso, g.ld_wso, R, pad8(L.s_out), min(g.wso_k, kp - k0), Act{},
        [&](int m, int n, float& v0, float& v1) {
          v0 = c > 0 ? f(s.S[m * g.lds + n]) : 0.f;
          v1 = c > 0 ? f(s.S[m * g.lds + n + 1]) : 0.f;
        },
        [&](int m, int n, float v0, float v1) {
          if (last) v0 += s.bso[n], v1 += s.bso[n + 1];
          put2(s.S + m * g.lds + n, n, L.s_out, v0, v1);
        });
  }
  __syncthreads();
  wso_free();
  if (L.vgate && kK2Products) {
    // G = act_v(S) @ Wg + bg
    if (L.act_v) {
      gate_logits<kSilu ? 2 : 1, T, R>(s, g, L);
    } else {
      gate_logits<0, T, R>(s, g, L);
    }
    __syncthreads();
  }
}

// layer_forward's wso_free for a caller that copies nothing then
struct NoHook {
  __device__ __forceinline__ void operator()() const {}
};

// layer_output's scalars: act_s(S) (act_s = kAct) written over (added to)
// M, and copied to slot.
template <int kAct, typename T, int R>
__device__ __forceinline__ void scalar_output(const Smem<T>& s, const Geom& g, const Layer& L, bool add, T* slot) {
  for (int i = threadIdx.x; i < R * L.s_out; i += kThreads) {
    const int r = i / L.s_out, o = i - r * L.s_out;
    T* m = s.M + r * g.ldm + o;
    store_f(m, (add ? f(*m) : 0.f) + act<kAct>(f(s.S[r * g.lds + o]), L.slope));
    if (slot) slot[r * L.s_out + o] = *m;
  }
}

// Layer L's output written over (ResGCP: added to) the state in M and X
// (rounded to T), and, unless slot is null, copied to slot ([R][s_out]
// scalars, then [3R][v_out] vectors).  kSilu as layer_forward's.
template <typename T, int R, bool kSilu>
__device__ inline void layer_output(const Smem<T>& s, const Geom& g, const Layer& L, bool add, T* slot) {
  if constexpr (!kK2Elementwise) {
    __syncthreads();
    return;
  }
  T* slot_v = slot ? slot + R * L.s_out : nullptr;
  for (int i = threadIdx.x; i < R * L.v_out; i += kThreads) {
    const int r = i / L.v_out, o = i - r * L.v_out;
    float u[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      u[c] = f(s.U[(r * 3 + c) * g.ldv + o]) + (L.vres ? f(s.X[(r * 3 + c) * g.ldx + o]) : 0.f);
    float gt = 1.f;
    if (L.vgate) {
      gt = sigmoid(f(s.G[r * g.ldv + o]));
    } else if (L.act_v) {
      gt = act<kSilu>(sqrtf(u[0] * u[0] + u[1] * u[1] + u[2] * u[2] + kEps) + kEps, L.act_v, L.slope);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T* x = s.X + (r * 3 + c) * g.ldx + o;
      store_f(x, (add ? f(*x) : 0.f) + u[c] * gt);
      if (slot) slot_v[(r * 3 + c) * L.v_out + o] = *x;
    }
  }
  if (L.act_s == 1) {
    scalar_output<1, T, R>(s, g, L, add, slot);
  } else if (L.act_s == 2) {
    scalar_output<2, T, R>(s, g, L, add, slot);
  } else if (kSilu && L.act_s == 3) {
    scalar_output<3, T, R>(s, g, L, add, slot);
  } else {
    scalar_output<0, T, R>(s, g, L, add, slot);
  }
  __syncthreads();
}

}  // namespace tc
}  // namespace gcp
