// Flash attention for training on Hopper (sm_90a): the forward and the two
// backward kernels of causal or full attention, GQA-aware, in the
// (B, H, S, D) layout, for float and bfloat16, D in {16, 32, 64, 128}.
//
//   flash_fwd_kernel      replaces the Pallas TPU kernel
//     ray_tpu/ops/pallas/flash_attention.py::flash_attention_fwd_pallas
//     (kernel _fwd_kernel): out and the f32 log-sum-exp per query row.
//   flash_bwd_dq_kernel   replaces flash_attention_bwd_pallas's first call
//     (kernel _bwd_dq_kernel): dQ = scale * dS K.
//   flash_bwd_dkv_kernel  replaces its second call (kernel _bwd_dkv_kernel):
//     dV = P^T dO and dK = scale * dS^T Q, the GQA group reduced inside the
//     block.
// with P = exp(scale * Q K^T - lse) recomputed from lse and
// dS = P o (dO V^T - delta), delta = rowsum(dO o O) - dlse from the caller.
//
// Semantics kept from the TPU kernels: causal masking is top-left aligned
// (row >= col); the kv tail past Skv and the q tail past Sq are masked in
// the kernel (no padded copies); a row with no unmasked column gets out 0
// and lse -1e30; kv rows come from kv head h / group (no repeat); lse is
// written straight to (B, Hq, Sq) f32.
//
// What bounds them: tensor-core operations. At the 1b_bench training shapes
// (B=8, Hq=32, Hkv=8, S=2048, D=64, causal) the forward does
// 4*B*H*S^2*D/2 = 137.4 GFLOP against 67 MB of q/k/v/out, far above the
// ~295 flop/byte ridge, so its least time is 0.139 ms at 989 TFLOP/s of
// bf16. The backward needs 2.5x that (0.347 ms for dq + dkv together); this
// split design recomputes S in both kernels and dP in both, so it does
// 206 GFLOP in dq and 275 GFLOP in dkv.
//
// Design (simple and right first):
//   * bfloat16: one block of 4 warps per (b*H, 64-row tile); each warp owns
//     16 rows and keeps its scores, probabilities and accumulators in
//     registers in the mma.sync m16n8k16 fragment layout (bf16 operands,
//     f32 accumulation), so S and P never touch shared memory: the C
//     fragment of S is repacked in registers as the A fragment of P V.
//     Operand tiles are staged to shared memory with 16-byte loads, rows
//     padded by 8 elements so fragment loads hit distinct banks.
//   * float: the same loops on CUDA cores with f32 FMA (no TF32): 32-row
//     tiles, 4 threads per row; a row's P or dS goes through shared memory
//     to the row's own 4 threads.
//   * dkv loops, per block, over (group member, q tile) pairs from the
//     causal diagonal on, so each kv tile's gradient is summed in
//     registers: no atomics, deterministic results.
//   * Causal loops stop at the diagonal (fwd, dq) or start there (dkv);
//     the fwd and dq grids start with the heaviest q tiles.
// Precision of the bfloat16 instantiation: P is rounded to bf16 before
// P V, as the TPU kernel does. The TPU backward takes dS K, dS^T Q and
// P^T dO in f32; here P and dS are rounded to bf16 for the tensor cores
// (relative error 2^-9 per term), so each row of out/dq/dk/dv is held to
// 2e-2 of its own norm against the f32 plain version, the tolerance
// ops/flash_attention.py states. The f32 instantiation computes everything
// in f32.
// Left for later: cp.async/TMA double buffering, wgmma with 64-row
// warpgroup tiles, a persistent schedule, and exp2 with a folded scale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kMaxSmem = 232448;           // bytes a block may use on H100

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <typename T, int D>
struct Cfg;

template <int D>
struct Cfg<bf16, D> {
  static constexpr int BQ = 64, BKV = 64;
  static constexpr int BQ_DKV = D <= 64 ? 64 : 32;   // register budget
  static constexpr int LD = D + 8;
  static constexpr size_t fwd_smem = (BQ + 2 * BKV) * LD * sizeof(bf16);
  static constexpr size_t dq_smem = (2 * BQ + 2 * BKV) * LD * sizeof(bf16);
  static constexpr size_t dkv_smem =
      (2 * BKV + 2 * BQ_DKV) * LD * sizeof(bf16) + 2 * BQ_DKV * sizeof(float);
};

template <int D>
struct Cfg<float, D> {
  static constexpr int BQ = 32, BKV = 32, BQ_DKV = 32;
  static constexpr int LD = D + 1;
  static constexpr size_t fwd_smem =
      (BQ * LD + BKV * LD + BKV * D + BQ * (BKV + 1)) * sizeof(float);
  static constexpr size_t dq_smem =
      (2 * BQ * LD + 2 * BKV * LD + BQ * (BKV + 1)) * sizeof(float);
  static constexpr size_t dkv_smem =
      (2 * BKV * LD + 2 * BQ_DKV * LD + 2 * BKV * (BQ_DKV + 1)
       + 2 * BQ_DKV) * sizeof(float);
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------------ bf16

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b for one 16x8x16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment (16 x 16) at rows r0.., columns k0.. of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* s, int ld,
                                       int r0, int k0, int lane) {
  const bf16* p = s + (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// B fragment (16 x 8, k x n) of X^T, X stored row-major as [n][k].
__device__ __forceinline__ void load_b_nk(uint32_t* b, const bf16* s, int ld,
                                          int n0, int k0, int lane) {
  const bf16* p = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment (16 x 8, k x n) of X, X stored row-major as [k][n].
__device__ __forceinline__ void load_b_kn(uint32_t* b, const bf16* s, int ld,
                                          int k0, int n0, int lane) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(s);
  const int i = (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  b[0] = static_cast<uint32_t>(u[i]) | (static_cast<uint32_t>(u[i + ld]) << 16);
  b[1] = static_cast<uint32_t>(u[i + 8 * ld])
         | (static_cast<uint32_t>(u[i + 9 * ld]) << 16);
}

// Copy `nrows` rows of D elements into shared rows of D + 8, zero past
// `avail` rows (the ragged tail is never read from device memory).
template <int D>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src,
                                           int avail, int nrows) {
  constexpr int C = D / 8;
  for (int i = threadIdx.x; i < nrows * C; i += kThreads) {
    const int r = i / C, c = i % C;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < avail) v = reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D)[c];
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c * 8) = v;
  }
}

// S (16 x 8*N per warp) = A rows [r0, r0+16) of sA times B^T, B = sB [n][k].
template <int D, int N>
__device__ __forceinline__ void warp_abt(float (*s)[4], const bf16* sA,
                                         const bf16* sB, int r0, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int n = 0; n < N; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    load_a(a, sA, LD, r0, kk, lane);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      uint32_t b[2];
      load_b_nk(b, sB, LD, n * 8, kk, lane);
      mma16816(s[n], a, b);
    }
  }
}

// acc (16 x D) += P (16 x 8*N, C fragments, rounded to bf16) times sB
// ([k][n] row-major, k over the N*8 columns of P).
template <int D, int N>
__device__ __forceinline__ void warp_pb(float (*acc)[4], float (*p)[4],
                                        const bf16* sB, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < N / 2; ++kk) {
    uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                     pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                     pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                     pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      uint32_t b[2];
      load_b_kn(b, sB, LD, kk * 16, dn * 8, lane);
      mma16816(acc[dn], a, b);
    }
  }
}

// Store a warp's 16 x D accumulator rows (times `mul`) as bf16; rows from
// `row0` (this thread's first row) and row0 + 8, only those below `limit`.
template <int D>
__device__ __forceinline__ void store_rows_bf16(bf16* dst, float (*acc)[4],
                                                int row0, int limit,
                                                float mul0, float mul1,
                                                int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 8 * i;
    if (r >= limit) continue;
    const float mul = i ? mul1 : mul0;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int col = dn * 8 + 2 * (lane & 3);
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(r) * D + col) =
          pack_bf16(acc[dn][2 * i] * mul, acc[dn][2 * i + 1] * mul);
    }
  }
}

template <int D>
__device__ __forceinline__ void fwd_mma(const bf16* __restrict__ q,
                                        const bf16* __restrict__ k,
                                        const bf16* __restrict__ v,
                                        bf16* __restrict__ out,
                                        float* __restrict__ lse, int Hq,
                                        int Hkv, int Sq, int Skv, float scale,
                                        int causal, unsigned char* smem) {
  using C = Cfg<bf16, D>;
  constexpr int BQ = C::BQ, BKV = C::BKV, LD = C::LD, NS = BKV / 8;
  const int qt = gridDim.x - 1 - blockIdx.x;     // heaviest tiles first
  const int bh = blockIdx.y;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int t = lane & 3;
  const int r_lo = q0 + wr + (lane >> 2);

  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LD;
  bf16* sV = sK + BKV * LD;
  const bf16* kb = k + static_cast<size_t>(kvh) * Skv * D;
  const bf16* vb = v + static_cast<size_t>(kvh) * Skv * D;
  stage_bf16<D>(sQ, q + (static_cast<size_t>(bh) * Sq + q0) * D, Sq - q0, BQ);

  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;

  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();
    stage_bf16<D>(sK, kb + static_cast<size_t>(k0) * D, Skv - k0, BKV);
    stage_bf16<D>(sV, vb + static_cast<size_t>(k0) * D, Skv - k0, BKV);
    __syncthreads();
    float s[NS][4];
    warp_abt<D, NS>(s, sQ, sK, wr, lane);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int r = r_lo + (e >> 1) * 8;
        const bool ok = col < Skv && (!causal || r >= col);
        s[n][e] = ok ? s[n][e] * scale : neg_inf();
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= alpha[0]; o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1]; o[dn][3] *= alpha[1];
    }
    warp_pb<D, NS>(o, s, sV, lane);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    inv[i] = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    const int r = r_lo + 8 * i;
    if (t == 0 && r < Sq) {
      lse[static_cast<size_t>(bh) * Sq + r] =
          l[i] == 0.f ? kNegInf : m[i] + logf(l[i]);
    }
  }
  store_rows_bf16<D>(out + static_cast<size_t>(bh) * Sq * D, o, r_lo, Sq,
                     inv[0], inv[1], lane);
}

template <int D>
__device__ __forceinline__ void dq_mma(const bf16* __restrict__ q,
                                       const bf16* __restrict__ k,
                                       const bf16* __restrict__ v,
                                       const bf16* __restrict__ dout,
                                       const float* __restrict__ lse,
                                       const float* __restrict__ delta,
                                       bf16* __restrict__ dq, int Hq, int Hkv,
                                       int Sq, int Skv, float scale,
                                       int causal, unsigned char* smem) {
  using C = Cfg<bf16, D>;
  constexpr int BQ = C::BQ, BKV = C::BKV, LD = C::LD, NS = BKV / 8;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int t = lane & 3;
  const int r_lo = q0 + wr + (lane >> 2);

  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + BQ * LD;
  bf16* sK = sdO + BQ * LD;
  bf16* sV = sK + BKV * LD;
  const size_t qoff = (static_cast<size_t>(bh) * Sq + q0) * D;
  stage_bf16<D>(sQ, q + qoff, Sq - q0, BQ);
  stage_bf16<D>(sdO, dout + qoff, Sq - q0, BQ);
  const bf16* kb = k + static_cast<size_t>(kvh) * Skv * D;
  const bf16* vb = v + static_cast<size_t>(kvh) * Skv * D;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    lse_r[i] = r < Sq ? lse[static_cast<size_t>(bh) * Sq + r] : 0.f;
    delta_r[i] = r < Sq ? delta[static_cast<size_t>(bh) * Sq + r] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;

  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();
    stage_bf16<D>(sK, kb + static_cast<size_t>(k0) * D, Skv - k0, BKV);
    stage_bf16<D>(sV, vb + static_cast<size_t>(k0) * D, Skv - k0, BKV);
    __syncthreads();
    float s[NS][4], dp[NS][4];
    warp_abt<D, NS>(s, sQ, sK, wr, lane);
    warp_abt<D, NS>(dp, sdO, sV, wr, lane);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const int i = e >> 1;
        const int r = r_lo + 8 * i;
        const bool ok = r < Sq && col < Skv && (!causal || r >= col);
        const float p = ok ? expf(s[n][e] * scale - lse_r[i]) : 0.f;
        s[n][e] = p * (dp[n][e] - delta_r[i]);
      }
    }
    warp_pb<D, NS>(acc, s, sK, lane);
  }
  store_rows_bf16<D>(dq + static_cast<size_t>(bh) * Sq * D, acc, r_lo, Sq,
                     scale, scale, lane);
}

template <int D>
__device__ __forceinline__ void dkv_mma(const bf16* __restrict__ q,
                                        const bf16* __restrict__ k,
                                        const bf16* __restrict__ v,
                                        const bf16* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta,
                                        bf16* __restrict__ dk,
                                        bf16* __restrict__ dv, int Hq,
                                        int Hkv, int Sq, int Skv, float scale,
                                        int causal, unsigned char* smem) {
  using C = Cfg<bf16, D>;
  constexpr int BQ = C::BQ_DKV, BKV = C::BKV, LD = C::LD, NQ = BQ / 8;
  const int bkv = blockIdx.y;
  const int k0 = blockIdx.x * BKV;               // heaviest causal tile first
  const int group = Hq / Hkv;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
  const int t = lane & 3;
  const int c_lo = k0 + wr + (lane >> 2);        // this thread's kv rows

  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BKV * LD;
  bf16* sQ = sV + BKV * LD;
  bf16* sdO = sQ + BQ * LD;
  float* sL = reinterpret_cast<float*>(sdO + BQ * LD);
  float* sDl = sL + BQ;
  const size_t koff = (static_cast<size_t>(bkv) * Skv + k0) * D;
  stage_bf16<D>(sK, k + koff, Skv - k0, BKV);
  stage_bf16<D>(sV, v + koff, Skv - k0, BKV);

  float gk[D / 8][4], gv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    gk[dn][0] = gk[dn][1] = gk[dn][2] = gk[dn][3] = 0.f;
    gv[dn][0] = gv[dn][1] = gv[dn][2] = gv[dn][3] = 0.f;
  }
  const int q_first = causal ? k0 / BQ : 0;
  const int nqt = (Sq + BQ - 1) / BQ;
  for (int gi = 0; gi < group; ++gi) {
    const size_t bhq = static_cast<size_t>(bkv / Hkv) * Hq
                       + (bkv % Hkv) * group + gi;
    for (int qt = q_first; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      const size_t qoff = (bhq * Sq + q0) * D;
      stage_bf16<D>(sQ, q + qoff, Sq - q0, BQ);
      stage_bf16<D>(sdO, dout + qoff, Sq - q0, BQ);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const bool in = q0 + i < Sq;
        sL[i] = in ? lse[bhq * Sq + q0 + i] : 0.f;
        sDl[i] = in ? delta[bhq * Sq + q0 + i] : 0.f;
      }
      __syncthreads();
      float st[NQ][4], dp[NQ][4];
      warp_abt<D, NQ>(st, sK, sQ, wr, lane);               // K Q^T
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = n * 8 + 2 * t + (e & 1);
          const int qr = q0 + qc;
          const int kr = c_lo + (e >> 1) * 8;
          const bool ok = qr < Sq && kr < Skv && (!causal || qr >= kr);
          st[n][e] = ok ? expf(st[n][e] * scale - sL[qc]) : 0.f;
        }
      }
      warp_pb<D, NQ>(gv, st, sdO, lane);                   // += P^T dO
      warp_abt<D, NQ>(dp, sV, sdO, wr, lane);              // V dO^T
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = n * 8 + 2 * t + (e & 1);
          st[n][e] *= dp[n][e] - sDl[qc];
        }
      }
      warp_pb<D, NQ>(gk, st, sQ, lane);                    // += dS^T Q
    }
  }
  const size_t base = static_cast<size_t>(bkv) * Skv * D;
  store_rows_bf16<D>(dk + base, gk, c_lo, Skv, scale, scale, lane);
  store_rows_bf16<D>(dv + base, gv, c_lo, Skv, 1.f, 1.f, lane);
}

// ------------------------------------------------------------------ f32

template <int LDS>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int avail, int nrows, int D) {
  for (int i = threadIdx.x; i < nrows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * LDS + c] = r < avail ? src[static_cast<size_t>(r) * D + c] : 0.f;
  }
}

__device__ __forceinline__ float dot_f32(const float* a, const float* b,
                                         int D) {
  float acc = 0.f;
#pragma unroll 16
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

// 4 threads per row (the lanes of a quad), 32 rows per block.
template <int D>
__device__ __forceinline__ void fwd_simt(const float* __restrict__ q,
                                         const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         float* __restrict__ out,
                                         float* __restrict__ lse, int Hq,
                                         int Hkv, int Sq, int Skv,
                                         float scale, int causal,
                                         unsigned char* smem) {
  using C = Cfg<float, D>;
  constexpr int BQ = C::BQ, BKV = C::BKV, LD = C::LD, NC = BKV / 4;
  constexpr int ND = D / 4, LP = BKV + 1;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int row = threadIdx.x >> 2, tq = threadIdx.x & 3;
  const int r = q0 + row;

  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + BQ * LD;
  float* sV = sK + BKV * LD;
  float* sP = sV + BKV * D;
  stage_f32<LD>(sQ, q + (static_cast<size_t>(bh) * Sq + q0) * D, Sq - q0,
                BQ, D);
  const float* kb = k + static_cast<size_t>(kvh) * Skv * D;
  const float* vb = v + static_cast<size_t>(kvh) * Skv * D;

  float acc[ND];
#pragma unroll
  for (int e = 0; e < ND; ++e) acc[e] = 0.f;
  float m = kNegInf, l = 0.f;
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;

  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();
    stage_f32<LD>(sK, kb + static_cast<size_t>(k0) * D, Skv - k0, BKV, D);
    stage_f32<D>(sV, vb + static_cast<size_t>(k0) * D, Skv - k0, BKV, D);
    __syncthreads();
    float s[NC];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tq + 4 * j, col = k0 + c;
      const bool ok = col < Skv && (!causal || r >= col);
      s[j] = ok ? dot_f32(sQ + row * LD, sK + c * LD, D) * scale : neg_inf();
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, quad_max(mx));
    const float alpha = expf(m - m_new);
    m = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float p = expf(s[j] - m_new);
      sum += p;
      sP[row * LP + tq + 4 * j] = p;
    }
    l = l * alpha + quad_sum(sum);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < ND; ++e) {
      const int d = tq + 4 * e;
      float a = acc[e] * alpha;
      for (int c = 0; c < BKV; ++c) a = fmaf(sP[row * LP + c], sV[c * D + d], a);
      acc[e] = a;
    }
  }
  if (r < Sq) {
    const float ls = l == 0.f ? 1.f : l;
    float* ob = out + (static_cast<size_t>(bh) * Sq + r) * D;
#pragma unroll
    for (int e = 0; e < ND; ++e) ob[tq + 4 * e] = acc[e] / ls;
    if (tq == 0) {
      lse[static_cast<size_t>(bh) * Sq + r] = l == 0.f ? kNegInf : m + logf(l);
    }
  }
}

template <int D>
__device__ __forceinline__ void dq_simt(const float* __restrict__ q,
                                        const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        const float* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta,
                                        float* __restrict__ dq, int Hq,
                                        int Hkv, int Sq, int Skv, float scale,
                                        int causal, unsigned char* smem) {
  using C = Cfg<float, D>;
  constexpr int BQ = C::BQ, BKV = C::BKV, LD = C::LD, NC = BKV / 4;
  constexpr int ND = D / 4, LP = BKV + 1;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int q0 = qt * BQ;
  const int row = threadIdx.x >> 2, tq = threadIdx.x & 3;
  const int r = q0 + row;

  float* sQ = reinterpret_cast<float*>(smem);
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BKV * LD;
  float* sS = sV + BKV * LD;
  const size_t qoff = (static_cast<size_t>(bh) * Sq + q0) * D;
  stage_f32<LD>(sQ, q + qoff, Sq - q0, BQ, D);
  stage_f32<LD>(sdO, dout + qoff, Sq - q0, BQ, D);
  const float* kb = k + static_cast<size_t>(kvh) * Skv * D;
  const float* vb = v + static_cast<size_t>(kvh) * Skv * D;
  const float lse_r = r < Sq ? lse[static_cast<size_t>(bh) * Sq + r] : 0.f;
  const float delta_r = r < Sq ? delta[static_cast<size_t>(bh) * Sq + r] : 0.f;

  float acc[ND];
#pragma unroll
  for (int e = 0; e < ND; ++e) acc[e] = 0.f;
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;

  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();
    stage_f32<LD>(sK, kb + static_cast<size_t>(k0) * D, Skv - k0, BKV, D);
    stage_f32<LD>(sV, vb + static_cast<size_t>(k0) * D, Skv - k0, BKV, D);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = tq + 4 * j, col = k0 + c;
      const bool ok = r < Sq && col < Skv && (!causal || r >= col);
      float ds = 0.f;
      if (ok) {
        const float p = expf(dot_f32(sQ + row * LD, sK + c * LD, D) * scale
                             - lse_r);
        ds = p * (dot_f32(sdO + row * LD, sV + c * LD, D) - delta_r);
      }
      sS[row * LP + c] = ds;
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < ND; ++e) {
      const int d = tq + 4 * e;
      float a = acc[e];
      for (int c = 0; c < BKV; ++c) a = fmaf(sS[row * LP + c], sK[c * LD + d], a);
      acc[e] = a;
    }
  }
  if (r < Sq) {
    float* ob = dq + (static_cast<size_t>(bh) * Sq + r) * D;
#pragma unroll
    for (int e = 0; e < ND; ++e) ob[tq + 4 * e] = acc[e] * scale;
  }
}

template <int D>
__device__ __forceinline__ void dkv_simt(const float* __restrict__ q,
                                         const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         const float* __restrict__ dout,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta,
                                         float* __restrict__ dk,
                                         float* __restrict__ dv, int Hq,
                                         int Hkv, int Sq, int Skv,
                                         float scale, int causal,
                                         unsigned char* smem) {
  using C = Cfg<float, D>;
  constexpr int BQ = C::BQ_DKV, BKV = C::BKV, LD = C::LD, NC = BQ / 4;
  constexpr int ND = D / 4, LP = BQ + 1;
  const int bkv = blockIdx.y;
  const int k0 = blockIdx.x * BKV;
  const int group = Hq / Hkv;
  const int row = threadIdx.x >> 2, tq = threadIdx.x & 3;
  const int kr = k0 + row;

  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + BKV * LD;
  float* sQ = sV + BKV * LD;
  float* sdO = sQ + BQ * LD;
  float* sP = sdO + BQ * LD;
  float* sS = sP + BKV * LP;
  float* sL = sS + BKV * LP;
  float* sDl = sL + BQ;
  const size_t koff = (static_cast<size_t>(bkv) * Skv + k0) * D;
  stage_f32<LD>(sK, k + koff, Skv - k0, BKV, D);
  stage_f32<LD>(sV, v + koff, Skv - k0, BKV, D);

  float gk[ND], gv[ND];
#pragma unroll
  for (int e = 0; e < ND; ++e) gk[e] = gv[e] = 0.f;
  const int q_first = causal ? k0 / BQ : 0;
  const int nqt = (Sq + BQ - 1) / BQ;
  for (int gi = 0; gi < group; ++gi) {
    const size_t bhq = static_cast<size_t>(bkv / Hkv) * Hq
                       + (bkv % Hkv) * group + gi;
    for (int qt = q_first; qt < nqt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      const size_t qoff = (bhq * Sq + q0) * D;
      stage_f32<LD>(sQ, q + qoff, Sq - q0, BQ, D);
      stage_f32<LD>(sdO, dout + qoff, Sq - q0, BQ, D);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const bool in = q0 + i < Sq;
        sL[i] = in ? lse[bhq * Sq + q0 + i] : 0.f;
        sDl[i] = in ? delta[bhq * Sq + q0 + i] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = tq + 4 * j, qr = q0 + c;
        const bool ok = qr < Sq && kr < Skv && (!causal || qr >= kr);
        float p = 0.f, ds = 0.f;
        if (ok) {
          p = expf(dot_f32(sK + row * LD, sQ + c * LD, D) * scale - sL[c]);
          ds = p * (dot_f32(sV + row * LD, sdO + c * LD, D) - sDl[c]);
        }
        sP[row * LP + c] = p;
        sS[row * LP + c] = ds;
      }
      __syncwarp();
#pragma unroll
      for (int e = 0; e < ND; ++e) {
        const int d = tq + 4 * e;
        float av = gv[e], ak = gk[e];
        for (int c = 0; c < BQ; ++c) {
          av = fmaf(sP[row * LP + c], sdO[c * LD + d], av);
          ak = fmaf(sS[row * LP + c], sQ[c * LD + d], ak);
        }
        gv[e] = av;
        gk[e] = ak;
      }
    }
  }
  if (kr < Skv) {
    const size_t o = (static_cast<size_t>(bkv) * Skv + kr) * D;
#pragma unroll
    for (int e = 0; e < ND; ++e) {
      dk[o + tq + 4 * e] = gk[e] * scale;
      dv[o + tq + 4 * e] = gv[e];
    }
  }
}

// ------------------------------------------------------------------ kernels

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* q, const T* k, const T* v, T* out, float* lse,
                 int Hq, int Hkv, int Sq, int Skv, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (std::is_same<T, float>::value) {
    fwd_simt<D>(q, k, v, out, lse, Hq, Hkv, Sq, Skv, scale, causal, smem);
  } else {
    fwd_mma<D>(q, k, v, out, lse, Hq, Hkv, Sq, Skv, scale, causal, smem);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* q, const T* k, const T* v, const T* dout,
                    const float* lse, const float* delta, T* dq, int Hq,
                    int Hkv, int Sq, int Skv, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (std::is_same<T, float>::value) {
    dq_simt<D>(q, k, v, dout, lse, delta, dq, Hq, Hkv, Sq, Skv, scale,
               causal, smem);
  } else {
    dq_mma<D>(q, k, v, dout, lse, delta, dq, Hq, Hkv, Sq, Skv, scale,
              causal, smem);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* q, const T* k, const T* v, const T* dout,
                     const float* lse, const float* delta, T* dk, T* dv,
                     int Hq, int Hkv, int Sq, int Skv, float scale,
                     int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (std::is_same<T, float>::value) {
    dkv_simt<D>(q, k, v, dout, lse, delta, dk, dv, Hq, Hkv, Sq, Skv, scale,
                causal, smem);
  } else {
    dkv_mma<D>(q, k, v, dout, lse, delta, dk, dv, Hq, Hkv, Sq, Skv, scale,
               causal, smem);
  }
}

// ------------------------------------------------------------------ host

struct Shape {
  int B, Hq, Hkv, Sq, Skv;
};

bool valid(const Shape& s) {
  return s.B > 0 && s.Hq > 0 && s.Hkv > 0 && s.Hq % s.Hkv == 0 && s.Sq > 0
         && s.Skv > 0 && static_cast<long long>(s.B) * s.Hq <= 65535;
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, Shape s, float scale, int causal,
                cudaStream_t st) {
  using C = Cfg<T, D>;
  cudaError_t err = prepare(flash_fwd_kernel<T, D>, C::fwd_smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.Sq + C::BQ - 1) / C::BQ, s.B * s.Hq);
  flash_fwd_kernel<T, D><<<grid, kThreads, C::fwd_smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), s.Hq, s.Hkv, s.Sq, s.Skv, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, Shape s, float scale, int causal,
                   cudaStream_t st) {
  using C = Cfg<T, D>;
  cudaError_t err = prepare(flash_bwd_dq_kernel<T, D>, C::dq_smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.Sq + C::BQ - 1) / C::BQ, s.B * s.Hq);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, C::dq_smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), s.Hq, s.Hkv, s.Sq, s.Skv, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, Shape s, float scale, int causal,
                    cudaStream_t st) {
  using C = Cfg<T, D>;
  cudaError_t err = prepare(flash_bwd_dkv_kernel<T, D>, C::dkv_smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.Skv + C::BKV - 1) / C::BKV, s.B * s.Hkv);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, C::dkv_smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), s.Hq, s.Hkv, s.Sq, s.Skv,
      scale, causal);
  return cudaGetLastError();
}

// Calls F<T, D>::run(args...) for the runtime dtype code and head dim.
#define FLASH_DISPATCH(FN, ...)                                              \
  do {                                                                       \
    if (dtype == 0) {                                                        \
      switch (D) {                                                           \
        case 16: return FN<float, 16>(__VA_ARGS__);                          \
        case 32: return FN<float, 32>(__VA_ARGS__);                          \
        case 64: return FN<float, 64>(__VA_ARGS__);                          \
        case 128: return FN<float, 128>(__VA_ARGS__);                        \
        default: return cudaErrorInvalidValue;                               \
      }                                                                      \
    }                                                                        \
    if (dtype == 1) {                                                        \
      switch (D) {                                                           \
        case 16: return FN<bf16, 16>(__VA_ARGS__);                           \
        case 32: return FN<bf16, 32>(__VA_ARGS__);                           \
        case 64: return FN<bf16, 64>(__VA_ARGS__);                           \
        case 128: return FN<bf16, 128>(__VA_ARGS__);                         \
        default: return cudaErrorInvalidValue;                               \
      }                                                                      \
    }                                                                        \
    return cudaErrorInvalidValue;                                            \
  } while (0)

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every launch returns a cudaError_t
// (0 on success). q/dout/out/dq (B, Hq, Sq, D); k/v/dk/dv (B, Hkv, Skv, D);
// lse/delta (B, Hq, Sq) float32; all contiguous.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int B, int Hq, int Hkv,
                                int Sq, int Skv, int D, float scale,
                                int causal, int dtype, void* stream) {
  const Shape s{B, Hq, Hkv, Sq, Skv};
  if (!valid(s)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(fwd, q, k, v, out, lse, s, scale, causal, st);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int B, int Hq, int Hkv, int Sq,
                                   int Skv, int D, float scale, int causal,
                                   int dtype, void* stream) {
  const Shape s{B, Hq, Hkv, Sq, Skv};
  if (!valid(s)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, dq, s, scale, causal, st);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int Hq,
                                    int Hkv, int Sq, int Skv, int D,
                                    float scale, int causal, int dtype,
                                    void* stream) {
  const Shape s{B, Hq, Hkv, Sq, Skv};
  if (!valid(s)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, s, scale,
                 causal, st);
}
