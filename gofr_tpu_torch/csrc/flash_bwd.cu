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
// - dQ, sm90 variant (bf16, D = 128: the training path; ops/flash.py::
//   dq_variant picks it): one block per (128-row q tile, q head, batch
//   row), wgmma, a TMA/mbarrier K/V ring, q tiles launched longest first
//   (flash_bwd_dq_sm90_kernel below, with its note).
// - dQ, mma variant (f32, D != 128): one block of 4 warps per (q tile, q
//   head, batch row), looping over K/V tiles up to min(cdiv(kv_len), causal
//   diagonal), the forward's bound.
// - dK/dV, sm90 variant (bf16, D = 128: the training path; ops/flash.py::
//   dkv_variant picks it): one block per (128-key tile, q head, batch row),
//   the blocks of a GQA group one thread block cluster that sums their f32
//   partials through distributed shared memory in a fixed order; wgmma, a
//   TMA/mbarrier Q/dO ring, key tiles launched longest first
//   (flash_bwd_dkv_sm90_kernel below, with its note).
// - dK/dV, mma variant (f32, D != 128): one block of 4 warps per (K/V
//   tile, kv head, batch row), looping over the GQA group's q heads and,
//   for each, the q tiles from the causal lower bound lo = max(0, (k0 -
//   offset) / block_q) to the end. The group sum the TPU made by
//   revisiting its output block happens in the block's f32 registers:
//   deterministic, no atomics.
// - bf16 mma (dQ and dK/dV at D != 128): tensor cores through mma.sync
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
// hi/lo split adds a fifth that the bound does not count). What both
// leave on the table: S and dP recomputed in both kernels (a fused kernel
// with atomic dQ would compute them once); neither sm90 variant overlaps
// one warpgroup's elementwise phase with its own next products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

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
  GOFR_DCHECK(q0 < a.sq && h < a.hq && kv_len <= a.skv);
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
  GOFR_DCHECK(k0 < a.skv && hk < a.hkv && kv_len <= a.skv);
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

// ------------------------------------------- bf16 dK/dV, D = 128: sm90

// One block of 384 threads per (128-key tile, q head, batch row); the
// `cluster` blocks of one KV head's GQA group form a thread block cluster
// along x (grid x = Hkv * cluster), key tiles along z in ascending order:
// under the causal mask the first key tiles have the most q tiles to
// visit, so they start first. Where groups > 8 (past the portable cluster
// size) a block walks `hpb` heads of its group in turn.
// - Warp 8, the producer (its warpgroup gives its registers to the two
//   consumer warpgroups: 240 + 240 + 24), loads the block's K and V tiles
//   once and streams 64-row Q/dO tiles through a four-stage ring by TMA;
//   its 32 lanes put
//   the rows' LSE (+inf past Sq, times log2 e) and D (0 past Sq) beside
//   them in shared memory before the stage's one arrival.
// - Warpgroups 0 and 1 own 64 keys each. Per Q/dO tile: S^T = K.Q^T and
//   dP^T = V.dO^T by wgmma (both operands in shared memory), P^T, dS^T and
//   the bf16 hi + lo split of P^T in registers, then dV += P^T_hi.dO +
//   P^T_lo.dO and dK += bf16(dS^T).Q by wgmma with the A operand in
//   registers and dO, Q read transposed from shared memory. dK and dV stay
//   f32 in registers, 64 x 128 each per warpgroup.
// - The group sum: each block writes its f32 dK/dV tile to its own shared
//   memory; after a cluster barrier, block r reads rows [r, r + 1) *
//   128 / cluster from every block of the cluster through distributed
//   shared memory, adds them in rank order 0, 1, ... and writes the bf16
//   result once. No atomics, the same order every launch.
// Keys past kv_len may hold anything (a NaN cache tail): P^T and dS^T are
// selected to 0 there, never multiplied, and their output rows are zeros.
constexpr int kD90BlockN = 128;  // keys per block
constexpr int kD90BlockM = 64;   // q rows per Q/dO tile
constexpr int kD90Stages = 4;
constexpr int kD90Threads = 384;  // warpgroup 2 holds the producer warp
constexpr int kD90Consumers = 256;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kD90KvHalf = kD90BlockN * 128;  // bytes: 128 rows x 64 bf16 columns
constexpr int kD90QHalf = kD90BlockM * 128;   // 64 rows x 64 bf16 columns
constexpr int kD90Stage = 4 * kD90QHalf;      // Q and dO, two halves each
constexpr int kD90RedLd = 136;                // f32 row pitch of the reduction tile
constexpr int kD90Red = 2 * kD90BlockN * kD90RedLd * 4;
constexpr int kD90Ring = 4 * kD90KvHalf + kD90Stages * kD90Stage;
constexpr int kD90Head = 4096;  // barriers, then LSE and D of every stage
constexpr int kD90Smem = kD90Head + (kD90Ring > kD90Red ? kD90Ring : kD90Red) + 1024;
static_assert(kD90Smem <= 232448, "more shared memory than a block may have");
constexpr float kLog2e = 1.4426950408889634f;

struct D90Args {
  const float *lse, *dvec;
  const int32_t *offsets, *kv_lens;
  bf16 *dk, *dv;
  int sq, skv, hq, hkv, groups, cluster, hpb;
  float scale, scale_log2;
  int causal;
};

// Block `rank` of the cluster sums its share of the key rows over every
// block's f32 partials (distributed shared memory, rank order 0, 1, ...)
// and writes them once as bf16; rows past kv_len as exact zeros.
__device__ __forceinline__ void dkv_group_sum(const D90Args& a, const float* red, uint32_t crank,
                                              int hk, int b, int k0, int kv_len, int tid) {
  const int r_lo = (int)crank * kD90BlockN / a.cluster;
  const int r_hi = ((int)crank + 1) * kD90BlockN / a.cluster;
  const int per = (r_hi - r_lo) * 32;  // float4 units of one tensor's share
  for (int idx = tid; idx < 2 * per; idx += kD90Consumers) {
    const int which = idx / per, r = r_lo + (idx % per) / 32, c = (idx % 32) * 4;
    GOFR_DCHECK(r >= r_lo && r < r_hi && r < kD90BlockN && which < 2);
    const int krow = k0 + r;
    if (krow >= a.skv) continue;
    const float* src = red + which * kD90BlockN * kD90RedLd + r * kD90RedLd + c;
    float4 part[kMaxCluster];  // all loads in flight at once, then the sum
#pragma unroll
    for (int rank = 0; rank < kMaxCluster; ++rank) {
      if (rank < a.cluster) part[rank] = ld_dsmem_f4(src, (uint32_t)rank);
    }
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int rank = 0; rank < kMaxCluster; ++rank) {  // a fixed order: deterministic
      if (rank < a.cluster) {
        sum.x += part[rank].x;
        sum.y += part[rank].y;
        sum.z += part[rank].z;
        sum.w += part[rank].w;
      }
    }
    const float mul = which == 0 ? a.scale : 1.f;
    bf16* dst = (which == 0 ? a.dk : a.dv) + (((int64_t)b * a.skv + krow) * a.hkv + hk) * 128 + c;
    uint2 packed = make_uint2(0u, 0u);  // exact zeros past kv_len
    if (krow < kv_len) {
      packed.x = pack_bf16(sum.x * mul, sum.y * mul);
      packed.y = pack_bf16(sum.z * mul, sum.w * mul);
    }
    *reinterpret_cast<uint2*>(dst) = packed;
  }
}

__global__ void __launch_bounds__(kD90Threads, 1) flash_bwd_dkv_sm90_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
    D90Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kD90Stages;
  float* lse_s = reinterpret_cast<float*>(smem + 64);  // [stage][64], times log2 e
  float* d_s = lse_s + kD90Stages * kD90BlockM;        // [stage][64]
  uint8_t* tiles = smem + kD90Head;
  uint8_t* ks = tiles;
  uint8_t* vs = tiles + 2 * kD90KvHalf;
  uint8_t* ring = tiles + 4 * kD90KvHalf;  // stage s: Q at ring + s * kD90Stage, dO after

  const uint32_t crank = cluster_rank();
  const int hk = blockIdx.x / a.cluster, b = blockIdx.y;
  const int h_first = hk * a.groups + (int)crank * a.hpb;
  const int k0 = blockIdx.z * kD90BlockN;
  const int offset = a.offsets[b];
  const int kv_len = min(max(a.kv_lens[b], 0), a.skv);
  const int n_qt = (a.sq + kD90BlockM - 1) / kD90BlockM;
  // q tiles before lo end before this key tile's first key
  const int lo = a.causal ? max(0, k0 - offset) / kD90BlockM : 0;
  const int per_head = k0 < kv_len ? max(0, n_qt - lo) : 0;
  const int n_it = per_head * a.hpb;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  GOFR_DCHECK(crank < (uint32_t)a.cluster && h_first + a.hpb <= a.hq && hk < a.hkv);
  GOFR_DCHECK(k0 < a.skv && kv_len <= a.skv && (per_head == 0 || lo < n_qt));

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kD90Stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kD90Consumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kD90Consumers / 32) {  // the producer warpgroup; warp 8 loads
    regs_dealloc<24>();
    if (warp == kD90Consumers / 32 && lane == 0 && n_it > 0) {
      mbar_arrive_expect_tx(kv_full, 4 * kD90KvHalf);
      tma_load_4d(ks, &kmap, kv_full, 0, hk, k0, b);
      tma_load_4d(ks + kD90KvHalf, &kmap, kv_full, 64, hk, k0, b);
      tma_load_4d(vs, &vmap, kv_full, 0, hk, k0, b);
      tma_load_4d(vs + kD90KvHalf, &vmap, kv_full, 64, hk, k0, b);
    }
    for (int it = 0; warp == kD90Consumers / 32 && it < n_it; ++it) {
      const int s = it % kD90Stages;
      const int h = h_first + it / per_head, q0 = (lo + it % per_head) * kD90BlockM;
      GOFR_DCHECK(h < h_first + a.hpb && q0 < a.sq);
      // the rows' LSE and D are read before the wait, so their latency
      // overlaps it; lanes own rows lane and lane + 32
      const int64_t lrow = ((int64_t)b * a.hq + h) * a.sq;
      float lse_r[2], d_r[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + lane + 32 * i;
        lse_r[i] = row < a.sq ? a.lse[lrow + row] * kLog2e : INFINITY;
        d_r[i] = row < a.sq ? a.dvec[lrow + row] : 0.f;
      }
      mbar_wait(&empty[s], ((it / kD90Stages) & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lse_s[s * kD90BlockM + lane + 32 * i] = lse_r[i];
        d_s[s * kD90BlockM + lane + 32 * i] = d_r[i];
      }
      __syncwarp();
      if (lane == 0) {
        uint8_t* qs = ring + s * kD90Stage;
        uint8_t* dos = qs + 2 * kD90QHalf;
        mbar_arrive_expect_tx(&full[s], kD90Stage);
        tma_load_4d(qs, &qmap, &full[s], 0, h, q0, b);
        tma_load_4d(qs + kD90QHalf, &qmap, &full[s], 64, h, q0, b);
        tma_load_4d(dos, &domap, &full[s], 0, h, q0, b);
        tma_load_4d(dos + kD90QHalf, &domap, &full[s], 64, h, q0, b);
      }
    }
    cluster_sync();  // the partials are in shared memory
    cluster_sync();  // and read
  } else {
    regs_alloc<240>();
    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
    const int wg = warp / 4, g = lane / 4, t = lane % 4;
    const int key_in = wg * 64 + (warp % 4) * 16 + g;  // this thread's keys: key_in, key_in + 8
    const int kpos0 = k0 + key_in;
    const uint32_t k_addr = smem_u32(ks) + wg * 64 * 128, v_addr = smem_u32(vs) + wg * 64 * 128;
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    if (n_it > 0) mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kD90Stages;
      const int q0 = (lo + it % per_head) * kD90BlockM;
      GOFR_DCHECK(q0 < a.sq);
      mbar_wait(&full[s], (it / kD90Stages) & 1);
      const uint32_t q_addr = smem_u32(ring + s * kD90Stage), do_addr = q_addr + 2 * kD90QHalf;

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t kv_off = (kk / 4) * kD90KvHalf + (kk % 4) * 32;
        const uint32_t q_off = (kk / 4) * kD90QHalf + (kk % 4) * 32;
        wgmma_m64n64k16_ss(st, smem_desc(k_addr + kv_off, 16, 1024),
                           smem_desc(q_addr + q_off, 16, 1024), kk > 0);
        wgmma_m64n64k16_ss(dpt, smem_desc(v_addr + kv_off, 16, 1024),
                           smem_desc(do_addr + q_off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // P^T (hi and lo) and dS^T in the A layout of the next products:
      // score n-tiles 2j and 2j + 1 (q columns) are k-step j
      const float* ls = lse_s + s * kD90BlockM;
      const float* dd = d_s + s * kD90BlockM;
      uint32_t p_hi[4][4], p_lo[4][4], dsf[4][4];
      // the warpgroup's 64 keys x 64 q rows need no mask when every key is
      // live, every row is < Sq and (causal) sees every key
      const int wg_last_key = k0 + wg * 64 + 63;
      const bool need_mask = wg_last_key >= kv_len || q0 + kD90BlockM > a.sq ||
                             (a.causal && wg_last_key > offset + q0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // this thread's q columns 8i + 2t and + 1, for keys kpos0 and + 8
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * i + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(dd + 8 * i + 2 * t);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * i + 2 * t + (e & 1);
          const int kpos = kpos0 + (e >> 1) * 8;
          const int row = q0 + qi;
          const bool valid = !need_mask || (kpos < kv_len && row < a.sq &&
                                            (!a.causal || kpos <= offset + row));
          // LSE +inf (a row with no key) gives exp2(-inf) = 0
          p[e] = valid ? exp2_fast(st[4 * i + e] * a.scale_log2 - ((e & 1) ? l2.y : l2.x)) : 0.f;
          ds[e] = valid ? p[e] * (dpt[4 * i + e] - ((e & 1) ? d2.y : d2.x)) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // hi = bf16(p), lo = bf16(p - hi): about 16 bits of p in all
          const uint32_t hi = pack_bf16(p[2 * r], p[2 * r + 1]);
          const float rest0 = p[2 * r] - __uint_as_float(hi << 16);
          const float rest1 = p[2 * r + 1] - __uint_as_float(hi & 0xffff0000u);
          p_hi[i / 2][(i & 1) * 2 + r] = hi;
          p_lo[i / 2][(i & 1) * 2 + r] = pack_bf16(rest0, rest1);
          dsf[i / 2][(i & 1) * 2 + r] = pack_bf16(ds[2 * r], ds[2 * r + 1]);
        }
      }

      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t dod = smem_desc(do_addr + j * 16 * 128, kD90QHalf, 1024);
        wgmma_m64n128k16_rs_tb(dv, p_hi[j], dod);
        wgmma_m64n128k16_rs_tb(dv, p_lo[j], dod);
        wgmma_m64n128k16_rs_tb(dk, dsf[j], smem_desc(q_addr + j * 16 * 128, kD90QHalf, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(p_hi);
      fence_regs(p_lo);
      fence_regs(dsf);
      mbar_arrive(&empty[s]);
    }

    // the group sum across the cluster: both warpgroups are done with the
    // ring (and so is every TMA load), so its memory takes the partials
    named_bar_sync(1, kD90Consumers);
    float* red = reinterpret_cast<float*>(tiles);  // dK then dV, [128][kD90RedLd] f32 each
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int o = (key_in + 8 * r) * kD90RedLd + 8 * n + 2 * t;
        *reinterpret_cast<float2*>(red + o) = make_float2(dk[4 * n + 2 * r], dk[4 * n + 2 * r + 1]);
        *reinterpret_cast<float2*>(red + kD90BlockN * kD90RedLd + o) =
            make_float2(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
      }
    }
    cluster_sync();
    dkv_group_sum(a, red, crank, hk, b, k0, kv_len, tid);
    cluster_sync();  // no block leaves while another reads its shared memory
  }
}

// ---------------------------------------------- bf16 dQ, D = 128: sm90

// One block of 384 threads per (128-row q tile, q head, batch row), the q
// tiles launched longest first under the causal mask (grid z reversed),
// as the sm90 forward.
// - Warp 8, the producer (its warpgroup gives its registers to the two
//   consumer warpgroups: 240 + 240 + 24), loads the block's Q and dO tiles
//   once and streams 64-key K/V tiles through a five-stage ring by TMA.
// - Warpgroups 0 and 1 own 64 q rows each, with their rows' LSE (times
//   log2 e; +inf past Sq) and D (0 past Sq) in registers. Per K/V tile: S =
//   Q.K^T and dP = dO.V^T by wgmma (both operands in shared memory,
//   K-major; two commit groups, so P is computed while dP runs: 0.159 ->
//   0.149 ms at the training shape), P and dS in registers, then dQ +=
//   bf16(dS).K by wgmma with dS as the register A operand and K read
//   transposed (MN-major), as the forward reads V for P.V. dQ stays f32 in
//   registers, 64 x 128 a warpgroup, and is written once: every block owns
//   its rows, no atomics.
// - 64-key tiles: dQ (64 f32 registers a thread) plus S and dP (32 each)
//   fit the consumers' 240; 128-key tiles would need 64 more.
// - Keys at or past kv_len inside Skv are loaded by TMA with whatever the
//   cache holds: those K rows are zeroed in shared memory before any
//   product reads them (dS is 0 there, but 0 * NaN is NaN), and P and dS
//   are selected to 0 for every masked (row, key). A warpgroup whose rows
//   see no key of a tile skips its products.
constexpr int kQ90BlockM = 128;  // q rows per block
constexpr int kQ90BlockN = 64;   // keys per K/V tile
constexpr int kQ90Stages = 5;
constexpr int kQ90Threads = 384;  // warpgroup 2 holds the producer warp
constexpr int kQ90Consumers = 256;
constexpr int kQ90QHalf = kQ90BlockM * 128;   // bytes: 128 rows x 64 bf16 columns
constexpr int kQ90KvHalf = kQ90BlockN * 128;  // 64 rows x 64 bf16 columns
constexpr int kQ90Stage = 4 * kQ90KvHalf;     // K and V, two halves each
constexpr int kQ90Smem = 1024 + 4 * kQ90QHalf + kQ90Stages * kQ90Stage + 1024;  // + alignment slack
static_assert(kQ90Smem <= 232448, "more shared memory than a block may have");

struct Q90Args {
  const float *lse, *dvec;
  const int32_t *offsets, *kv_lens;
  bf16* dq;
  int sq, skv, hq, groups, n_qt;
  float scale, scale_log2;
  int causal;
};

__global__ void __launch_bounds__(kQ90Threads, 1) flash_bwd_dq_sm90_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
    Q90Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kQ90Stages;
  uint8_t* qs = smem + 1024;
  uint8_t* dos = qs + 2 * kQ90QHalf;
  uint8_t* ring = dos + 2 * kQ90QHalf;  // stage s: K at ring + s * kQ90Stage, V after

  const int h = blockIdx.x, b = blockIdx.y, hk = h / a.groups;
  // longest first: under the causal mask the last q tiles see the most keys
  const int qt = a.causal ? a.n_qt - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int q0 = qt * kQ90BlockM;
  const int offset = a.offsets[b];
  const int kv_len = min(max(a.kv_lens[b], 0), a.skv);
  int hi = (kv_len + kQ90BlockN - 1) / kQ90BlockN;
  if (a.causal) {
    const int last = offset + min(q0 + kQ90BlockM, a.sq);  // exclusive
    hi = min(hi, max(0, (last + kQ90BlockN - 1) / kQ90BlockN));
  }
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  GOFR_DCHECK((int)gridDim.x == a.hq && (int)gridDim.z == a.n_qt);
  GOFR_DCHECK(qt >= 0 && qt < a.n_qt && q0 < a.sq);
  GOFR_DCHECK(hk * a.groups <= h && kv_len <= a.skv && hi <= (a.skv + kQ90BlockN - 1) / kQ90BlockN);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kQ90Stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kQ90Consumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kQ90Consumers / 32) {  // the producer warpgroup; warp 8 loads
    regs_dealloc<24>();
    if (warp == kQ90Consumers / 32 && lane == 0 && hi > 0) {
      mbar_arrive_expect_tx(q_full, 4 * kQ90QHalf);
      tma_load_4d(qs, &qmap, q_full, 0, h, q0, b);
      tma_load_4d(qs + kQ90QHalf, &qmap, q_full, 64, h, q0, b);
      tma_load_4d(dos, &domap, q_full, 0, h, q0, b);
      tma_load_4d(dos + kQ90QHalf, &domap, q_full, 64, h, q0, b);
      for (int j = 0; j < hi; ++j) {
        const int s = j % kQ90Stages;
        mbar_wait(&empty[s], ((j / kQ90Stages) & 1) ^ 1);
        uint8_t* ks = ring + s * kQ90Stage;
        uint8_t* vs = ks + 2 * kQ90KvHalf;
        mbar_arrive_expect_tx(&full[s], kQ90Stage);
        tma_load_4d(ks, &kmap, &full[s], 0, hk, j * kQ90BlockN, b);
        tma_load_4d(ks + kQ90KvHalf, &kmap, &full[s], 64, hk, j * kQ90BlockN, b);
        tma_load_4d(vs, &vmap, &full[s], 0, hk, j * kQ90BlockN, b);
        tma_load_4d(vs + kQ90KvHalf, &vmap, &full[s], 64, hk, j * kQ90BlockN, b);
      }
    }
    return;
  }

  regs_alloc<240>();
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int row_in = wg * 64 + (warp % 4) * 16 + g;  // this thread's rows: row_in, row_in + 8
  const int wg_row0 = q0 + wg * 64;                   // the warpgroup's first q row
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * 128, do_addr = smem_u32(dos) + wg * 64 * 128;
  // rows past Sq get LSE +inf, so P = 0 there
  float lse_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row_in + 8 * r;
    const int64_t i = ((int64_t)b * a.hq + h) * a.sq + row;
    lse_r[r] = row < a.sq ? a.lse[i] * kLog2e : INFINITY;
    d_r[r] = row < a.sq ? a.dvec[i] : 0.f;
  }

  float acc[64], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
  if (hi > 0) mbar_wait(q_full, 0);

  for (int j = 0; j < hi; ++j) {
    const int s = j % kQ90Stages;
    const int k0 = j * kQ90BlockN;
    GOFR_DCHECK(k0 < kv_len);
    mbar_wait(&full[s], (j / kQ90Stages) & 1);
    uint8_t* ks = ring + s * kQ90Stage;
    const uint32_t k_addr = smem_u32(ks), v_addr = k_addr + 2 * kQ90KvHalf;
    if (k0 + kQ90BlockN > kv_len) {
      // the tile holds keys at or past kv_len: zero those K rows before
      // any product reads them (both warpgroups write the same zeros)
      const int first = kv_len - k0;
      GOFR_DCHECK(first > 0 && first < kQ90BlockN);
      for (int c = tid; c < (kQ90BlockN - first) * 16; c += kQ90Consumers) {
        const int r = first + c / 16, half = (c / 8) % 2, chunk = c % 8;
        GOFR_DCHECK(r < kQ90BlockN);
        *reinterpret_cast<uint4*>(ks + half * kQ90KvHalf + r * 128 + chunk * 16) =
            make_uint4(0, 0, 0, 0);
      }
      fence_proxy_async();
      named_bar_sync(1, kQ90Consumers);
    }
    // under the causal mask the warpgroup's rows may see no key of the tile
    if (!a.causal || k0 <= offset + wg_row0 + 63) {
      // S and dP in two commit groups: P is computed while dP still runs
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_m64n64k16_ss(sc, smem_desc(q_addr + (kk / 4) * kQ90QHalf + (kk % 4) * 32, 16, 1024),
                           smem_desc(k_addr + (kk / 4) * kQ90KvHalf + (kk % 4) * 32, 16, 1024),
                           kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_m64n64k16_ss(dp, smem_desc(do_addr + (kk / 4) * kQ90QHalf + (kk % 4) * 32, 16, 1024),
                           smem_desc(v_addr + (kk / 4) * kQ90KvHalf + (kk % 4) * 32, 16, 1024),
                           kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // the warpgroup's 64 rows x 64 keys need no mask when every key is
      // live, every row is < Sq and (causal) sees every key
      const bool need_mask = k0 + kQ90BlockN > kv_len || wg_row0 + 64 > a.sq ||
                             (a.causal && k0 + kQ90BlockN - 1 > offset + wg_row0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * i + 2 * t + (e & 1);
          const int row = q0 + row_in + 8 * (e >> 1);
          const bool valid = !need_mask || (kpos < kv_len && row < a.sq &&
                                            (!a.causal || kpos <= offset + row));
          // P in place of S; LSE +inf (a row with no key) gives exp2(-inf) = 0
          sc[4 * i + e] = valid ? exp2_fast(sc[4 * i + e] * a.scale_log2 - lse_r[e >> 1]) : 0.f;
        }
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS in the A layout of dS.K: score n-tiles 2i and 2i + 1 are k-step i.
      // P = 0 (masked, or underflowed) gives dS = 0 by select: dP may be
      // NaN there, from V rows past kv_len
      uint32_t dsf[4][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = sc[4 * i + e];
          ds[e] = p > 0.f ? p * (dp[4 * i + e] - d_r[e >> 1]) : 0.f;
        }
        dsf[i / 2][(i & 1) * 2 + 0] = pack_bf16(ds[0], ds[1]);
        dsf[i / 2][(i & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_m64n128k16_rs_tb(acc, dsf[kk], smem_desc(k_addr + kk * 16 * 128, kQ90KvHalf, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(dsf);
    }
    mbar_arrive(&empty[s]);
  }

  const int64_t o_ss = (int64_t)a.hq * 128;  // dQ is [B, Sq, Hq, D] contiguous
  bf16* dqb = a.dq + (int64_t)b * a.sq * o_ss + (int64_t)h * 128;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row_in + 8 * r;
    if (row >= a.sq) continue;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      *reinterpret_cast<uint32_t*>(dqb + row * o_ss + n * 8 + 2 * t) =
          pack_bf16(acc[4 * n + 2 * r] * a.scale, acc[4 * n + 2 * r + 1] * a.scale);
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
  GOFR_DCHECK(q0 < a.sq && h < a.hq && kv_len <= a.skv);
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
  GOFR_DCHECK(k0 < a.skv && hk < a.hkv && kv_len <= a.skv);
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

// The sm90 dK/dV kernel (bf16, D = 128; the caller picks it). q, k, v and
// dout rows must be 16-byte aligned (pointers and strides: TMA reads them);
// dout, dk, dv, lse and dvec are contiguous. The grid is (Hkv * cluster, B,
// cdiv(Skv, 128)) in clusters of `cluster` blocks along x, each block
// walking `hpb` q heads, with cluster * hpb = Hq / Hkv and cluster <= 8;
// ops/flash.py::dkv_sm90_geometry computes them. Returns a cudaError_t
// value (0 on success).
int gofr_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* dvec, const void* offsets,
                            const void* kv_lens, void* dk, void* dv,
                            int b, int sq, int skv, int hq, int hkv,
                            int64_t qsb, int64_t qss, int64_t qsh,
                            int64_t ksb, int64_t kss, int64_t ksh,
                            int64_t vsb, int64_t vss, int64_t vsh,
                            float scale, int causal, int grid_x, int grid_y, int grid_z,
                            int cluster, int hpb, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hkv < 1 || hq % hkv || cluster < 1 || cluster > kMaxCluster || cluster * hpb != hq / hkv ||
      grid_x != hkv * cluster || grid_y != b || grid_z != (skv + kD90BlockN - 1) / kD90BlockN) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap qm, km, vm, dom;
  const int64_t o_ss = (int64_t)hq * 128;  // dout is [B, Sq, Hq, D] contiguous
  int rc = make_bf16_map(&qm, q, b, sq, hq, 128, qsb, qss, qsh, kD90BlockM);
  if (rc == 0) rc = make_bf16_map(&dom, dout, b, sq, hq, 128, sq * o_ss, o_ss, 128, kD90BlockM);
  if (rc == 0) rc = make_bf16_map(&km, k, b, skv, hkv, 128, ksb, kss, ksh, kD90BlockN);
  if (rc == 0) rc = make_bf16_map(&vm, v, b, skv, hkv, 128, vsb, vss, vsh, kD90BlockN);
  if (rc != 0) return rc;
  err = cudaFuncSetAttribute(flash_bwd_dkv_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kD90Smem);
  if (err != cudaSuccess) return (int)err;
  D90Args a;
  a.lse = static_cast<const float*>(lse);
  a.dvec = static_cast<const float*>(dvec);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.kv_lens = static_cast<const int32_t*>(kv_lens);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.sq = sq;
  a.skv = skv;
  a.hq = hq;
  a.hkv = hkv;
  a.groups = hq / hkv;
  a.cluster = cluster;
  a.hpb = hpb;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  a.causal = causal;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, grid_y, grid_z);
  cfg.blockDim = dim3(kD90Threads);
  cfg.dynamicSmemBytes = kD90Smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_dkv_sm90_kernel, qm, km, vm, dom, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The sm90 dQ kernel (bf16, D = 128; the caller picks it). q, k, v and dout
// rows must be 16-byte aligned (pointers and strides: TMA reads them);
// dout, dq, lse and dvec are contiguous. The grid is (Hq, B, cdiv(Sq,
// 128)), the q tiles launched longest first when causal; ops/flash.py::
// dq_sm90_grid computes it. Returns a cudaError_t value (0 on success).
int gofr_flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* dvec, const void* offsets,
                           const void* kv_lens, void* dq,
                           int b, int sq, int skv, int hq, int hkv,
                           int64_t qsb, int64_t qss, int64_t qsh,
                           int64_t ksb, int64_t kss, int64_t ksh,
                           int64_t vsb, int64_t vss, int64_t vsh,
                           float scale, int causal, int grid_x, int grid_y, int grid_z,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hkv < 1 || hq % hkv || sq < 1 || grid_x != hq || grid_y != b ||
      grid_z != (sq + kQ90BlockM - 1) / kQ90BlockM) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap qm, km, vm, dom;
  const int64_t o_ss = (int64_t)hq * 128;  // dout is [B, Sq, Hq, D] contiguous
  int rc = make_bf16_map(&qm, q, b, sq, hq, 128, qsb, qss, qsh, kQ90BlockM);
  if (rc == 0) rc = make_bf16_map(&dom, dout, b, sq, hq, 128, sq * o_ss, o_ss, 128, kQ90BlockM);
  if (rc == 0) rc = make_bf16_map(&km, k, b, skv, hkv, 128, ksb, kss, ksh, kQ90BlockN);
  if (rc == 0) rc = make_bf16_map(&vm, v, b, skv, hkv, 128, vsb, vss, vsh, kQ90BlockN);
  if (rc != 0) return rc;
  err = cudaFuncSetAttribute(flash_bwd_dq_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kQ90Smem);
  if (err != cudaSuccess) return (int)err;
  Q90Args a;
  a.lse = static_cast<const float*>(lse);
  a.dvec = static_cast<const float*>(dvec);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.kv_lens = static_cast<const int32_t*>(kv_lens);
  a.dq = static_cast<bf16*>(dq);
  a.sq = sq;
  a.skv = skv;
  a.hq = hq;
  a.groups = hq / hkv;
  a.n_qt = grid_z;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  a.causal = causal;
  flash_bwd_dq_sm90_kernel<<<dim3(grid_x, grid_y, grid_z), kQ90Threads, kQ90Smem,
                             static_cast<cudaStream_t>(stream)>>>(qm, km, vm, dom, a);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a block of the sm90 variants, in bytes.
int gofr_flash_bwd_dkv_sm90_smem() { return kD90Smem; }
int gofr_flash_bwd_dq_sm90_smem() { return kQ90Smem; }

}  // extern "C"
