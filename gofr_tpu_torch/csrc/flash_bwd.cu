// Flash-attention backward for NVIDIA Hopper (sm_90a), bound with ctypes:
// two kernels, dQ and dK/dV, that recompute the probabilities from the
// forward's log-sum-exp so the [Sq, Skv] score matrix never reaches memory.
//
// Replaces:
// - dQ:    gofr_tpu/ops/flash.py::_dq_kernel, launched by _flash_bwd_impl
//          through pl.pallas_call (gofr_tpu/ops/flash.py:477);
// - dK/dV: gofr_tpu/ops/flash.py::_dkv_kernel, launched by _flash_bwd_impl
//          through pl.pallas_call (gofr_tpu/ops/flash.py:521).
// Same function: S = Q.K^T * scale, masked at -1e30 (keys at or past
// kv_len, and past the causal diagonal), P = exp(S - LSE) in f32 with P = 0
// outright where the key is masked or the row's LSE is +inf (a row that
// saw no key), dP = dO.V^T, dS = P * (dP - D) with D = rowsum(dO * O)
// precomputed by the caller; dQ = scale * bf16(dS).K, dK = scale *
// bf16(dS)^T.Q, dV = P^T.dO, all accumulated in f32 and written once in
// the inputs' dtype.
//
// Layout: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] read in place with the
// caller's strides (head dim contiguous; bf16 rows 16-byte aligned). dO and
// dQ are [B, Sq, Hq, D] contiguous, dK and dV [B, Skv, Hkv, D] contiguous,
// lse and D [B, Hq, Sq] f32 contiguous.
//
// Every output element is written: dK/dV rows at or past kv_len, and whole
// K/V tiles that no query sees, get exact zeros; a row with kv_len = 0
// gets dQ = 0. The TPU padded Sq and Skv with zeros and relied on padded
// rows having dO = 0 and D = 0; here nothing is padded, so both kernels
// mask query rows >= Sq and keys >= min(kv_len, Skv) themselves.
//
// Work split, each block reading its own q_offset and kv_len (the TPU's
// scalar prefetch):
// - dQ: one block of 4 warps per (q tile, q head, batch row), looping over
//   K/V tiles up to min(cdiv(kv_len), causal diagonal), the forward's bound.
// - dK/dV: one block of 4 warps per (K/V tile, kv head, batch row), looping
//   over the GQA group's q heads and, for each, the q tiles from the causal
//   lower bound lo = max(0, (k0 - offset) / block_q) to the end. The group
//   sum the TPU made by revisiting its output block happens in the block's
//   f32 registers: deterministic, no atomics.
// - bf16 (the training path, D = 128): tensor cores through mma.sync
//   m16n8k16. dQ: a 64-row q tile, 16 rows per warp, Q and dO fragments in
//   registers, 32-key K/V tiles in shared memory; dS goes from the C
//   registers straight into the A operand of dS.K. dK/dV: a 64-key tile,
//   16 keys per warp, the transposed products S^T = K.Q^T and dP^T = V.dO^T
//   over 32-row Q/dO tiles in (dynamic) shared memory, and dK, dV as 16 x D
//   f32 accumulators per warp. P stays f32 for dV = P^T.dO as in the TPU
//   kernel: it is split into bf16 hi + lo parts (two products), which keeps
//   about 16 bits of P's mantissa where one bf16 product would keep 8.
//   dO and V are bf16 inputs, so dO.V^T on bf16 tensor cores with f32
//   accumulation is the TPU's f32 product of the same values.
// - f32 (the tiny model's check): CUDA-core FMAs, 16-row q tiles and
//   32-key K/V tiles in shared memory, one key per lane for the scores.
//
// What bounds them on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s HBM): at
// the training shape (S = 2048, D = 128) operations, 6*D*Hq*(visible pairs)
// for dQ (three products) and 8*D*Hq*(visible pairs) for dK/dV (four; the
// hi/lo split adds a fifth that the bound does not count). What this simple
// design leaves on the table: mma.sync instead of wgmma, synchronous tile
// loads (no cp.async or TMA pipeline), each K/V (dQ) or Q/dO (dK/dV) tile
// read again by every block that needs it, and S and dP recomputed in both
// kernels (a fused kernel with atomic dQ would compute them once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

typedef __nv_bfloat16 bf16;

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *dvec;
  const int32_t *offsets, *kv_lens;
  void *dq, *dk, *dv;
  int b, sq, skv, hq, hkv;
  Strides st;
  float scale;
  int causal;
  cudaStream_t stream;
};

// ---------------------------------------------------------------- bf16 dQ

constexpr int kDqBlockQ = 16 * kWarps;  // 64 q rows per block
constexpr int kDqBlockKV = 32;           // keys per K/V tile

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16_kernel(Args a) {
  constexpr int LD = D + 8;  // 16 bytes of padding per row
  constexpr int KSTEPS = D / 16;
  constexpr int NT_S = kDqBlockKV / 8;  // score n-tiles per warp
  constexpr int NT_O = D / 8;           // dQ n-tiles per warp
  static_assert(D % 16 == 0, "head dim");

  __shared__ __align__(16) bf16 ks[kDqBlockKV * LD];
  __shared__ __align__(16) bf16 vs[kDqBlockKV * LD];

  const int h = blockIdx.y, b = blockIdx.z, hk = h / (a.hq / a.hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kDqBlockQ;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int offset = a.offsets[b];
  const int kv_len = min(max(a.kv_lens[b], 0), a.skv);
  const bool active = q0 + warp * 16 < a.sq;  // a warp past Sq only helps load
  const Strides& st = a.st;
  const int64_t o_ss = (int64_t)a.hq * D;  // dO and dQ: [B, Sq, Hq, D] contiguous

  const bf16* qb = static_cast<const bf16*>(a.q) + b * st.qb + h * st.qh;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * st.kb + hk * st.kh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * st.vb + hk * st.vh;
  const bf16* dob = static_cast<const bf16*>(a.dout) + (int64_t)b * a.sq * o_ss + h * D;

  uint32_t qf[KSTEPS][4], df[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // cols +0 and +8
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {  // rows +0 and +8
        const int row = row0 + rr * 8;
        const int col = kk * 16 + half * 8 + 2 * t;
        uint32_t x = 0, y = 0;
        if (row < a.sq) {
          x = pack_raw(qb[row * st.qs + col], qb[row * st.qs + col + 1]);
          y = pack_raw(dob[row * o_ss + col], dob[row * o_ss + col + 1]);
        }
        qf[kk][half * 2 + rr] = x;
        df[kk][half * 2 + rr] = y;
      }
    }
  }
  // rows past Sq get LSE +inf, so P = 0 there
  float lse_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const int64_t i = ((int64_t)b * a.hq + h) * a.sq + row;
    lse_r[r] = row < a.sq ? a.lse[i] : INFINITY;
    d_r[r] = row < a.sq ? a.dvec[i] : 0.f;
  }

  int hi = (kv_len + kDqBlockKV - 1) / kDqBlockKV;
  if (a.causal) {
    const int last_q = offset + q0 + kDqBlockQ;  // exclusive
    hi = min(hi, max(0, (last_q + kDqBlockKV - 1) / kDqBlockKV));
  }

  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int qpos0 = offset + row0;

  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kDqBlockKV;
    __syncthreads();  // the previous tile is consumed
    for (int c = tid; c < kDqBlockKV * D / 8; c += kThreads) {
      const int r = c / (D / 8), col = (c % (D / 8)) * 8;
      const int pos = k0 + r;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (pos < kv_len) {
        kx = *reinterpret_cast<const uint4*>(kb + pos * st.ks + col);
        vx = *reinterpret_cast<const uint4*>(vb + pos * st.vs + col);
      }
      *reinterpret_cast<uint4*>(&ks[r * LD + col]) = kx;
      *reinterpret_cast<uint4*>(&vs[r * LD + col]) = vx;
    }
    __syncthreads();
    if (!active) continue;

    float s[NT_S][4], dp[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      const bf16* krow = &ks[(n * 8 + g) * LD + 2 * t];
      const bf16* vrow = &vs[(n * 8 + g) * LD + 2 * t];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        mma_16816(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(krow + kk * 16),
                  *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8));
        mma_16816(dp[n], df[kk], *reinterpret_cast<const uint32_t*>(vrow + kk * 16),
                  *reinterpret_cast<const uint32_t*>(vrow + kk * 16 + 8));
      }
    }

    uint32_t dsf[kDqBlockKV / 16][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        const bool valid = kpos < kv_len && (!a.causal || kpos <= qpos0 + r * 8) &&
                           lse_r[r] < INFINITY;
        const float p = valid ? expf(s[n][e] * a.scale - lse_r[r]) : 0.f;
        ds[e] = p * (dp[n][e] - d_r[r]);
      }
      dsf[n / 2][(n & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
      dsf[n / 2][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
#pragma unroll
    for (int i = 0; i < kDqBlockKV / 16; ++i) {
      const bf16* k0p = &ks[(i * 16 + 2 * t) * LD + g];
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const bf16* kc = k0p + n * 8;
        mma_16816(acc[n], dsf[i], pack_raw(kc[0], kc[LD]), pack_raw(kc[8 * LD], kc[9 * LD]));
      }
    }
  }
  if (!active) return;

  bf16* dqb = static_cast<bf16*>(a.dq) + (int64_t)b * a.sq * o_ss + (int64_t)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= a.sq) continue;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      *reinterpret_cast<uint32_t*>(dqb + row * o_ss + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * r] * a.scale, acc[n][2 * r + 1] * a.scale);
    }
  }
}

// ------------------------------------------------------------- bf16 dK/dV

constexpr int kKvBlockKV = 16 * kWarps;  // 64 keys per block
constexpr int kKvBlockQ = 32;             // q rows per Q/dO tile

template <int D>
constexpr int dkv_bf16_smem() {
  return (2 * kKvBlockKV + 2 * kKvBlockQ) * (D + 8) * 2 + 2 * kKvBlockQ * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_bf16_kernel(Args a) {
  constexpr int LD = D + 8;
  constexpr int KSTEPS = D / 16;
  constexpr int NT_S = kKvBlockQ / 8;  // score n-tiles (q columns) per warp
  constexpr int NT_O = D / 8;          // dK/dV n-tiles per warp
  static_assert(D % 16 == 0, "head dim");

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [64][LD]
  bf16* vs = ks + kKvBlockKV * LD;           // [64][LD]
  bf16* qs = vs + kKvBlockKV * LD;           // [32][LD]
  bf16* dos = qs + kKvBlockQ * LD;           // [32][LD]
  float* lse_s = reinterpret_cast<float*>(dos + kKvBlockQ * LD);  // [32]
  float* d_s = lse_s + kKvBlockQ;                                  // [32]

  const int hk = blockIdx.y, b = blockIdx.z, groups = a.hq / a.hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kKvBlockKV;
  const int wrow = warp * 16;           // this warp's keys in the tile
  const int kpos0 = k0 + wrow + g;      // this thread's keys: kpos0, kpos0 + 8
  const int offset = a.offsets[b];
  const int kv_len = min(max(a.kv_lens[b], 0), a.skv);
  const Strides& st = a.st;
  const int64_t o_ss = (int64_t)a.hq * D;

  const bf16* kb = static_cast<const bf16*>(a.k) + b * st.kb + hk * st.kh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * st.vb + hk * st.vh;

  float dk[NT_O][4], dv[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  if (k0 < kv_len) {  // else no key of the tile is live: all zeros
    for (int c = tid; c < kKvBlockKV * D / 8; c += kThreads) {
      const int r = c / (D / 8), col = (c % (D / 8)) * 8;
      const int pos = k0 + r;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = make_uint4(0, 0, 0, 0);
      if (pos < kv_len) {
        kx = *reinterpret_cast<const uint4*>(kb + pos * st.ks + col);
        vx = *reinterpret_cast<const uint4*>(vb + pos * st.vs + col);
      }
      *reinterpret_cast<uint4*>(&ks[r * LD + col]) = kx;
      *reinterpret_cast<uint4*>(&vs[r * LD + col]) = vx;
    }
    const int n_qt = (a.sq + kKvBlockQ - 1) / kKvBlockQ;
    // q tiles before lo end before this K/V tile's first key; C's
    // truncating division agrees with floor here only under the max(0, .)
    const int lo = a.causal ? max(0, (k0 - offset) / kKvBlockQ) : 0;

    for (int gi = 0; gi < groups; ++gi) {
      const int h = hk * groups + gi;
      const bf16* qb = static_cast<const bf16*>(a.q) + b * st.qb + h * st.qh;
      const bf16* dob = static_cast<const bf16*>(a.dout) + (int64_t)b * a.sq * o_ss + h * D;
      const int64_t lrow = ((int64_t)b * a.hq + h) * a.sq;
      for (int qt = lo; qt < n_qt; ++qt) {
        const int q0 = qt * kKvBlockQ;
        __syncthreads();  // K/V staged; the previous Q/dO tile consumed
        for (int c = tid; c < kKvBlockQ * D / 8; c += kThreads) {
          const int r = c / (D / 8), col = (c % (D / 8)) * 8;
          const int row = q0 + r;
          uint4 qx = make_uint4(0, 0, 0, 0), dx = make_uint4(0, 0, 0, 0);
          if (row < a.sq) {
            qx = *reinterpret_cast<const uint4*>(qb + row * st.qs + col);
            dx = *reinterpret_cast<const uint4*>(dob + row * o_ss + col);
          }
          *reinterpret_cast<uint4*>(&qs[r * LD + col]) = qx;
          *reinterpret_cast<uint4*>(&dos[r * LD + col]) = dx;
        }
        if (tid < kKvBlockQ) {
          const int row = q0 + tid;
          lse_s[tid] = row < a.sq ? a.lse[lrow + row] : INFINITY;  // P = 0 past Sq
          d_s[tid] = row < a.sq ? a.dvec[lrow + row] : 0.f;
        }
        __syncthreads();

        // S^T = K.Q^T and dP^T = V.dO^T: 16 keys x 32 q rows per warp
        float s[NT_S][4], dp[NT_S][4];
#pragma unroll
        for (int n = 0; n < NT_S; ++n) {
          s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
          dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t ka[4], va[4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int off = (wrow + g + rr * 8) * LD + kk * 16 + half * 8 + 2 * t;
              ka[half * 2 + rr] = *reinterpret_cast<const uint32_t*>(&ks[off]);
              va[half * 2 + rr] = *reinterpret_cast<const uint32_t*>(&vs[off]);
            }
          }
#pragma unroll
          for (int n = 0; n < NT_S; ++n) {
            const bf16* qrow = &qs[(n * 8 + g) * LD + kk * 16 + 2 * t];
            const bf16* drow = &dos[(n * 8 + g) * LD + kk * 16 + 2 * t];
            mma_16816(s[n], ka, *reinterpret_cast<const uint32_t*>(qrow),
                      *reinterpret_cast<const uint32_t*>(qrow + 8));
            mma_16816(dp[n], va, *reinterpret_cast<const uint32_t*>(drow),
                      *reinterpret_cast<const uint32_t*>(drow + 8));
          }
        }

        uint32_t p_hi[kKvBlockQ / 16][4], p_lo[kKvBlockQ / 16][4], dsf[kKvBlockQ / 16][4];
#pragma unroll
        for (int n = 0; n < NT_S; ++n) {
          float p[4], ds[4], lo_part[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = kpos0 + (e >> 1) * 8;
            const int qi = n * 8 + 2 * t + (e & 1);
            const float lse = lse_s[qi];
            const bool valid = kpos < kv_len && (!a.causal || kpos <= offset + q0 + qi) &&
                               lse < INFINITY;
            p[e] = valid ? expf(s[n][e] * a.scale - lse) : 0.f;
            ds[e] = p[e] * (dp[n][e] - d_s[qi]);
            lo_part[e] = p[e] - __bfloat162float(__float2bfloat16_rn(p[e]));
          }
          p_hi[n / 2][(n & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
          p_hi[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
          p_lo[n / 2][(n & 1) * 2 + 0] = pack_bf16(lo_part[0], lo_part[1]);
          p_lo[n / 2][(n & 1) * 2 + 1] = pack_bf16(lo_part[2], lo_part[3]);
          dsf[n / 2][(n & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
          dsf[n / 2][(n & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }

        // dV += P^T.dO (hi and lo parts), dK += bf16(dS)^T.Q
#pragma unroll
        for (int i = 0; i < kKvBlockQ / 16; ++i) {
          const bf16* d0 = &dos[(i * 16 + 2 * t) * LD + g];
          const bf16* q0p = &qs[(i * 16 + 2 * t) * LD + g];
#pragma unroll
          for (int n = 0; n < NT_O; ++n) {
            const bf16* dc = d0 + n * 8;
            const uint32_t b0 = pack_raw(dc[0], dc[LD]), b1 = pack_raw(dc[8 * LD], dc[9 * LD]);
            mma_16816(dv[n], p_hi[i], b0, b1);
            mma_16816(dv[n], p_lo[i], b0, b1);
            const bf16* qc = q0p + n * 8;
            mma_16816(dk[n], dsf[i], pack_raw(qc[0], qc[LD]), pack_raw(qc[8 * LD], qc[9 * LD]));
          }
        }
      }
    }
  }

  bf16* dkb = static_cast<bf16*>(a.dk) + (int64_t)b * a.skv * a.hkv * D + (int64_t)hk * D;
  bf16* dvb = static_cast<bf16*>(a.dv) + (int64_t)b * a.skv * a.hkv * D + (int64_t)hk * D;
  const int64_t kv_ss = (int64_t)a.hkv * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kpos0 + r * 8;
    if (row >= a.skv) continue;
    const bool live = row < kv_len;  // exact zeros past the written prefix
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const int64_t o = row * kv_ss + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkb + o) =
          live ? pack_bf16(dk[n][2 * r] * a.scale, dk[n][2 * r + 1] * a.scale) : 0u;
      *reinterpret_cast<uint32_t*>(dvb + o) =
          live ? pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]) : 0u;
    }
  }
}

// ----------------------------------------------------------------- f32 path

constexpr int kBlockQ = 16;
constexpr int kBlockKV = 32;  // one key per lane
constexpr int kRowsPerWarp = kBlockQ / kWarps;

template <int D>
constexpr int dq_f32_smem() {
  return (2 * kBlockQ + 2 * kBlockKV) * (D + 1) * 4 + (kBlockQ * kBlockKV + 2 * kBlockQ) * 4;
}

template <int D>
constexpr int dkv_f32_smem() {
  return (2 * kBlockQ + 2 * kBlockKV) * (D + 1) * 4 + (2 * kBlockQ * kBlockKV + 2 * kBlockQ) * 4;
}

// One warp's score rows for one K/V tile: lane = key. Writes P (if p_out)
// and dS for rows warp, warp + 4, ... of the q tile at q0.
template <int D>
__device__ __forceinline__ void f32_scores(const Args& a, const float* qs, const float* dos,
                                           const float* ks, const float* vs,
                                           const float* lse_s, const float* d_s, int q0,
                                           int kpos, int kv_len, int offset, int warp,
                                           int lane, float* p_out, float* ds_out) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kWarps;
    float s = 0.f, dp = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      s = fmaf(qs[r * LD + d], ks[lane * LD + d], s);
      dp = fmaf(dos[r * LD + d], vs[lane * LD + d], dp);
    }
    const bool valid = kpos < kv_len && (!a.causal || kpos <= offset + q0 + r) &&
                       lse_s[r] < INFINITY;  // +inf past Sq and on rows with no key
    const float p = valid ? expf(s * a.scale - lse_s[r]) : 0.f;
    if (p_out) p_out[r * kBlockKV + lane] = p;
    ds_out[r * kBlockKV + lane] = p * (dp - d_s[r]);
  }
}

// Stages rows [q0, q0 + 16) of q and dO (zeros past Sq), their LSE (+inf
// past Sq) and D.
template <int D>
__device__ __forceinline__ void f32_load_q(const Args& a, const float* qb, const float* dob,
                                           int64_t lrow, int q0, int tid, float* qs,
                                           float* dos, float* lse_s, float* d_s) {
  constexpr int LD = D + 1;
  const int64_t o_ss = (int64_t)a.hq * D;
  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int row = q0 + r;
    qs[r * LD + c] = row < a.sq ? qb[row * a.st.qs + c] : 0.f;
    dos[r * LD + c] = row < a.sq ? dob[row * o_ss + c] : 0.f;
  }
  if (tid < kBlockQ) {
    const int row = q0 + tid;
    lse_s[tid] = row < a.sq ? a.lse[lrow + row] : INFINITY;
    d_s[tid] = row < a.sq ? a.dvec[lrow + row] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void f32_load_kv(const Args& a, const float* kb, const float* vb,
                                            int k0, int kv_len, int tid, float* ks, float* vs) {
  constexpr int LD = D + 1;
  for (int e = tid; e < kBlockKV * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int pos = k0 + r;
    const bool live = pos < kv_len;  // never read past the written prefix
    ks[r * LD + c] = live ? kb[pos * a.st.ks + c] : 0.f;
    vs[r * LD + c] = live ? vb[pos * a.st.vs + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32_kernel(Args a) {
  constexpr int LD = D + 1;  // lane-strided row reads hit 32 distinct banks
  constexpr int kRowGroups = kThreads / D;        // threads per dQ column
  constexpr int kAccRows = kBlockQ / kRowGroups;  // dQ rows per thread
  static_assert(kThreads % D == 0 && kBlockQ % kRowGroups == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + kBlockQ * LD;
  float* ks = dos + kBlockQ * LD;
  float* vs = ks + kBlockKV * LD;
  float* dss = vs + kBlockKV * LD;  // [16][32]
  float* lse_s = dss + kBlockQ * kBlockKV;
  float* d_s = lse_s + kBlockQ;

  const int h = blockIdx.y, b = blockIdx.z, hk = h / (a.hq / a.hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBlockQ;
  const int offset = a.offsets[b];
  const int kv_len = min(max(a.kv_lens[b], 0), a.skv);
  const int64_t o_ss = (int64_t)a.hq * D;

  const float* qb = static_cast<const float*>(a.q) + b * a.st.qb + h * a.st.qh;
  const float* kb = static_cast<const float*>(a.k) + b * a.st.kb + hk * a.st.kh;
  const float* vb = static_cast<const float*>(a.v) + b * a.st.vb + hk * a.st.vh;
  const float* dob = static_cast<const float*>(a.dout) + (int64_t)b * a.sq * o_ss + h * D;
  f32_load_q<D>(a, qb, dob, ((int64_t)b * a.hq + h) * a.sq, q0, tid, qs, dos, lse_s, d_s);

  int hi = (kv_len + kBlockKV - 1) / kBlockKV;
  if (a.causal) {
    const int last_q = offset + q0 + kBlockQ;  // exclusive
    hi = min(hi, max(0, (last_q + kBlockKV - 1) / kBlockKV));
  }
  const int dcol = tid % D, rgroup = tid / D;
  float acc[kAccRows];
#pragma unroll
  for (int i = 0; i < kAccRows; ++i) acc[i] = 0.f;

  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kBlockKV;
    __syncthreads();  // Q staged; the previous tile's ks/vs/dss consumed
    f32_load_kv<D>(a, kb, vb, k0, kv_len, tid, ks, vs);
    __syncthreads();
    f32_scores<D>(a, qs, dos, ks, vs, lse_s, d_s, q0, k0 + lane, kv_len, offset, warp, lane,
                  nullptr, dss);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAccRows; ++i) {
      const int r = rgroup + i * kRowGroups;
      float x = acc[i];
#pragma unroll 8
      for (int c = 0; c < kBlockKV; ++c) x = fmaf(dss[r * kBlockKV + c], ks[c * LD + dcol], x);
      acc[i] = x;
    }
  }

  float* dqb = static_cast<float*>(a.dq) + (int64_t)b * a.sq * o_ss + (int64_t)h * D;
#pragma unroll
  for (int i = 0; i < kAccRows; ++i) {
    const int row = q0 + rgroup + i * kRowGroups;
    if (row < a.sq) dqb[row * o_ss + dcol] = acc[i] * a.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_f32_kernel(Args a) {
  constexpr int LD = D + 1;
  constexpr int kKeyGroups = kThreads / D;        // threads per dK/dV column
  constexpr int kAccKeys = kBlockKV / kKeyGroups;  // keys per thread
  static_assert(kThreads % D == 0 && kBlockKV % kKeyGroups == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + kBlockQ * LD;
  float* ks = dos + kBlockQ * LD;
  float* vs = ks + kBlockKV * LD;
  float* ps = vs + kBlockKV * LD;     // [16][32]
  float* dss = ps + kBlockQ * kBlockKV;  // [16][32]
  float* lse_s = dss + kBlockQ * kBlockKV;
  float* d_s = lse_s + kBlockQ;

  const int hk = blockIdx.y, b = blockIdx.z, groups = a.hq / a.hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kBlockKV;
  const int offset = a.offsets[b];
  const int kv_len = min(max(a.kv_lens[b], 0), a.skv);
  const int64_t o_ss = (int64_t)a.hq * D;
  const int dcol = tid % D, kgroup = tid / D;

  float dk[kAccKeys], dv[kAccKeys];
#pragma unroll
  for (int i = 0; i < kAccKeys; ++i) dk[i] = dv[i] = 0.f;

  if (k0 < kv_len) {
    const float* kb = static_cast<const float*>(a.k) + b * a.st.kb + hk * a.st.kh;
    const float* vb = static_cast<const float*>(a.v) + b * a.st.vb + hk * a.st.vh;
    f32_load_kv<D>(a, kb, vb, k0, kv_len, tid, ks, vs);
    const int n_qt = (a.sq + kBlockQ - 1) / kBlockQ;
    const int lo = a.causal ? max(0, (k0 - offset) / kBlockQ) : 0;  // see the bf16 kernel
    for (int gi = 0; gi < groups; ++gi) {
      const int h = hk * groups + gi;
      const float* qb = static_cast<const float*>(a.q) + b * a.st.qb + h * a.st.qh;
      const float* dob = static_cast<const float*>(a.dout) + (int64_t)b * a.sq * o_ss + h * D;
      for (int qt = lo; qt < n_qt; ++qt) {
        const int q0 = qt * kBlockQ;
        __syncthreads();  // K/V staged; the previous Q/dO tile consumed
        f32_load_q<D>(a, qb, dob, ((int64_t)b * a.hq + h) * a.sq, q0, tid, qs, dos, lse_s, d_s);
        __syncthreads();
        f32_scores<D>(a, qs, dos, ks, vs, lse_s, d_s, q0, k0 + lane, kv_len, offset, warp, lane,
                      ps, dss);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kAccKeys; ++i) {
          const int key = kgroup + i * kKeyGroups;
          float x = dk[i], y = dv[i];
#pragma unroll
          for (int r = 0; r < kBlockQ; ++r) {
            x = fmaf(dss[r * kBlockKV + key], qs[r * LD + dcol], x);
            y = fmaf(ps[r * kBlockKV + key], dos[r * LD + dcol], y);
          }
          dk[i] = x;
          dv[i] = y;
        }
      }
    }
  }

  const int64_t kv_ss = (int64_t)a.hkv * D;
  float* dkb = static_cast<float*>(a.dk) + (int64_t)b * a.skv * kv_ss + (int64_t)hk * D;
  float* dvb = static_cast<float*>(a.dv) + (int64_t)b * a.skv * kv_ss + (int64_t)hk * D;
#pragma unroll
  for (int i = 0; i < kAccKeys; ++i) {
    const int row = k0 + kgroup + i * kKeyGroups;
    if (row >= a.skv) continue;
    const bool live = row < kv_len;  // exact zeros past the written prefix
    dkb[row * kv_ss + dcol] = live ? dk[i] * a.scale : 0.f;
    dvb[row * kv_ss + dcol] = live ? dv[i] : 0.f;
  }
}

// ------------------------------------------------------------------ launch

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, const Args& a) {
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, a.stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(int dtype, int which, const Args& a) {
  if (dtype == 1) {
    if (which == 0) {
      dim3 grid((a.sq + kDqBlockQ - 1) / kDqBlockQ, a.hq, a.b);
      return launch(flash_bwd_dq_bf16_kernel<D>, grid, 0, a);
    }
    dim3 grid((a.skv + kKvBlockKV - 1) / kKvBlockKV, a.hkv, a.b);
    return launch(flash_bwd_dkv_bf16_kernel<D>, grid, dkv_bf16_smem<D>(), a);
  }
  if (which == 0) {
    dim3 grid((a.sq + kBlockQ - 1) / kBlockQ, a.hq, a.b);
    return launch(flash_bwd_dq_f32_kernel<D>, grid, dq_f32_smem<D>(), a);
  }
  dim3 grid((a.skv + kBlockKV - 1) / kBlockKV, a.hkv, a.b);
  return launch(flash_bwd_dkv_f32_kernel<D>, grid, dkv_f32_smem<D>(), a);
}

int dispatch(int dtype, int d, int which, const Args& a) {
  if ((dtype != 0 && dtype != 1) || (which != 0 && which != 1)) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16: return (int)launch_d<16>(dtype, which, a);
    case 32: return (int)launch_d<32>(dtype, which, a);
    case 64: return (int)launch_d<64>(dtype, which, a);
    case 128: return (int)launch_d<128>(dtype, which, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// which: 0 = the dQ kernel (writes dq), 1 = the dK/dV kernel (writes dk and
// dv). dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for the
// batch, sequence and head dims of q, k and v in that order; for bf16, q, k
// and v rows must be 16-byte aligned (pointers and strides). dout, dq, dk,
// dv, lse and dvec are contiguous. Returns the launch's cudaGetLastError()
// (0 on success).
int gofr_flash_bwd(int which, int dtype, int head_dim, const void* q, const void* k,
                   const void* v, const void* dout, const void* lse, const void* dvec,
                   const void* offsets, const void* kv_lens, void* dq, void* dk, void* dv,
                   int b, int sq, int skv, int hq, int hkv,
                   int64_t qsb, int64_t qss, int64_t qsh,
                   int64_t ksb, int64_t kss, int64_t ksh,
                   int64_t vsb, int64_t vss, int64_t vsh,
                   float scale, int causal, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.dvec = static_cast<const float*>(dvec);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.kv_lens = static_cast<const int32_t*>(kv_lens);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.b = b;
  a.sq = sq;
  a.skv = skv;
  a.hq = hq;
  a.hkv = hkv;
  a.st = Strides{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  a.scale = scale;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, head_dim, which, a);
}

}  // extern "C"
