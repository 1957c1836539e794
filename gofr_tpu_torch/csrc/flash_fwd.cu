// Flash-attention forward for NVIDIA Hopper (sm_90a), bound with ctypes.
//
// Replaces: gofr_tpu/ops/flash.py::_kernel, launched by _flash_fwd_impl
// through pl.pallas_call (gofr_tpu/ops/flash.py:224). Same function:
// online softmax in f32 over K/V tiles, GQA head map h -> h / groups,
// KV loop bounded by min(cdiv(kv_len), causal diagonal), masked scores at
// -1e30, out in q's dtype plus a per-row log-sum-exp (f32) for the later
// backward kernels; a row that sees no key gets out = 0 and LSE = +inf.
//
// Layout: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D], read in place with the
// strides the caller passes (head dim contiguous; bf16 K/V rows 16-byte
// aligned, loaded 16 bytes a thread). The TPU kernel's swap
// to [B, H, S, D] was a TPU tiling need and is not carried over. out is
// [B, Sq, Hq, D] contiguous, lse [B, Hq, Sq] contiguous.
//
// Each block reads its own q_offset and kv_len (the TPU's scalar
// prefetch) and loops over K/V tiles staged in shared memory. Scores, the
// running (m, l, acc) and P.V accumulate in f32; P is rounded to the value
// dtype before P.V, as the TPU kernel does; masked keys get p = 0.
// Three variants; ops/flash.py::fwd_variant picks one by shape:
// - sm90 (bf16, D = 64 or 128, Sq >= 64: training, serving prefill and the
//   encoder): wgmma and a TMA/mbarrier K/V ring, warp-specialised, 128-row
//   q tiles launched longest first (sm90_fwd below, with its note; one
//   instance per head dim). TMA loads whole tiles, so V rows at or past
//   kv_len reach shared memory and are zeroed there before P.V.
// - decode (bf16, D = 128, Sq x groups <= 32: the serving path's decode and
//   speculation's verify): the GQA group's query rows packed into one m16
//   row tile, or two past 16 rows; split-KV across a thread block cluster, a
//   cp.async K/V ring and one deterministic merge through distributed
//   shared memory (decode_fwd below; one instance per row-tile count).
// - mma (everything else: short tails, f32, D = 64 decode, other D): one
//   block of 128 threads (4 warps) per (q tile, q head, batch row); keys at
//   or past kv_len are never read (their tile rows are zero-filled).
// - mma, bf16: tensor cores through mma.sync m16n8k16. A
//   64-row q tile, 16 rows per warp; each warp keeps its Q fragments, its
//   64-key score tile and its 16 x D output accumulator in registers, and
//   feeds P to P.V straight from the score registers (FlashAttention-2).
//   K/V tiles of 64 keys are bf16 in shared memory, rows padded by 16 bytes
//   so every fragment load hits 32 distinct banks.
// - mma, f32 (the tiny model's check): CUDA-core FMAs. A 16-row q tile, 32-key
//   K/V tiles as f32 in shared memory (rows padded by one word), one key
//   per lane for the scores, one output column per thread for P.V.
//
// What bounds it on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s HBM):
// - decode and verify (Sq x groups <= 32): bytes, K+V of kv_len tokens per
//   (batch, kv head);
// - the encoder (S = 128, D = 64): bytes, but each call is a few
//   microseconds, so launch and latency weigh as much;
// - long prefill: operations, 4*B*Hq*Sq*Skv*D, about half that when causal.
// What the sm90 variant still leaves on the table: its two warpgroups do
// not overlap one tile's softmax with the other's products (no ping-pong),
// and the output leaves from registers rather than through TMA; at the
// encoder's S = 128 a block has one K/V tile, so nothing overlaps its loads.
// What the mma variant leaves: mma.sync (about half the wgmma rate),
// synchronous tile loads; no path of llama3-8b or bert runs it on the card.
// What the decode variant leaves: each block streams its tiles far below
// its share of HBM's rate (latency-bound: a tile's wait, products and
// softmax run in series in four warps a row tile), and the launch, cluster
// barriers and merge cost a few microseconds; the serving step around it is
// host-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------- bf16 path

constexpr int kMmaBlockQ = 16 * kWarps;  // 64 q rows per block
constexpr int kMmaBlockKV = 64;           // keys per K/V tile

// Fragment layouts: see mma_bf16.cuh.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ kv_lens, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int sq, int skv, int hq, int groups, Strides st, float scale,
    int causal) {
  constexpr int LD = D + 8;  // 16 bytes of padding per row
  constexpr int KSTEPS = D / 16;
  constexpr int NT_S = kMmaBlockKV / 8;  // score n-tiles per warp
  constexpr int NT_O = D / 8;            // output n-tiles per warp
  static_assert(D % 16 == 0, "head dim");

  __shared__ __align__(16) __nv_bfloat16 ks[kMmaBlockKV * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kMmaBlockKV * LD];

  const int h = blockIdx.y, b = blockIdx.z, hk = h / groups;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kMmaBlockQ;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int offset = offsets[b];
  const int kv_len = min(max(kv_lens[b], 0), skv);
  const bool active = q0 + warp * 16 < sq;  // a warp past Sq only helps load
  GOFR_DCHECK(q0 < sq && h < hq && hk * groups <= h && kv_len <= skv);

  const __nv_bfloat16* qb = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kb = k + b * st.kb + hk * st.kh;
  const __nv_bfloat16* vb = v + b * st.vb + hk * st.vh;

  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // cols +0 and +8
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {  // rows +0 and +8
        const int row = row0 + rr * 8;
        const int col = kk * 16 + half * 8 + 2 * t;
        uint32_t x = 0;
        if (row < sq) x = pack_raw(qb[row * st.qs + col], qb[row * st.qs + col + 1]);
        qf[kk][half * 2 + rr] = x;
      }
    }
  }

  int hi = (kv_len + kMmaBlockKV - 1) / kMmaBlockKV;
  if (causal) {
    const int last_q = offset + q0 + kMmaBlockQ;  // exclusive
    hi = min(hi, max(0, (last_q + kMmaBlockKV - 1) / kMmaBlockKV));
  }

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  const int qpos0 = offset + row0;

  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kMmaBlockKV;
    __syncthreads();  // the previous tile is consumed
    // 16 bytes a thread: K/V rows are 16-byte aligned (the wrapper checks)
    for (int c = tid; c < kMmaBlockKV * D / 8; c += kThreads) {
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

    float s[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = &ks[(n * 8 + g) * LD + 2 * t];
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_16816(s[n], qf[kk], b0, b1);
      }
    }

    // mask, then the online softmax over this tile (rows row0 and row0 + 8;
    // the 4 threads of a quad hold a row between them)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        const int qpos = qpos0 + (e >> 1) * 8;
        const bool valid = kpos < kv_len && (!causal || kpos <= qpos);
        s[n][e] = valid ? s[n][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2], m_new[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new[r]);
    }
    uint32_t pf[kMmaBlockKV / 16][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked keys contribute exactly 0, never exp(-1e30 - m)
        p[e] = s[n][e] > 0.5f * kNegInf ? expf(s[n][e] - m_new[e >> 1]) : 0.f;
        rsum[e >> 1] += p[e];
      }
      // the score tile's C layout is P.V's A layout: n-tiles 2i, 2i+1
      // form the 16-key k-step i
      pf[n / 2][(n & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[n / 2][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l_run[r] = alpha[r] * l_run[r] + rsum[r];
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int i = 0; i < kMmaBlockKV / 16; ++i) {
      const __nv_bfloat16* v0 = &vs[(i * 16 + 2 * t) * LD + g];
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const __nv_bfloat16* vc = v0 + n * 8;
        const uint32_t b0 = pack_raw(vc[0], vc[LD]);
        const uint32_t b1 = pack_raw(vc[8 * LD], vc[9 * LD]);
        mma_16816(o[n], pf[i], b0, b1);
      }
    }
  }
  if (!active) return;

  const int64_t out_ss = (int64_t)hq * D;  // out is [B, Sq, Hq, D] contiguous
  __nv_bfloat16* ob = out + (int64_t)b * sq * out_ss + (int64_t)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= sq) continue;
    const float inv = 1.f / (l_run[r] == 0.f ? 1.f : l_run[r]);
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      *reinterpret_cast<uint32_t*>(ob + row * out_ss + n * 8 + 2 * t) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
    if (t == 0) {
      lse[((int64_t)b * hq + h) * sq + row] =
          l_run[r] > 0.f ? m_run[r] + logf(l_run[r]) : INFINITY;
    }
  }
}

// ------------------------------------- bf16, D = 64 or 128, Sq >= 64: sm90

// One block of 384 threads per (128-row q tile, q head, batch row): warps
// 0-7 are two consumer warpgroups of 64 q rows each, warp 8 the producer
// (its warpgroup gives its registers to the consumers: 240 + 240 + 24 a
// thread, the SM's 512 a sub-partition lane).
// The producer loads the Q tile once and streams 128-key K/V tiles through
// a three-stage ring by TMA (full/empty mbarriers). Each consumer warpgroup
// computes S = Q.K^T with wgmma (Q and K from shared memory), the online
// softmax on the score registers, and O += P.V with wgmma (P in registers
// as the A operand, V read transposed from shared memory).
// One body, two instances: D = 128 (llama's training and prefill), whose
// tiles are two 64-column halves, and D = 64 (bert's encoder), one half a
// tile: Q.K^T takes D / 16 k-steps and P.V a wgmma of N = D, so a D = 64
// stage is half the bytes. The encoder's q/k/v are strided views of the
// fused wqkv product: the tensor maps take the caller's strides, nothing is
// copied.
constexpr int kF90BlockM = 128;
constexpr int kF90BlockN = 128;
constexpr int kF90Stages = 3;
constexpr int kF90Threads = 384;  // warpgroup 2 holds the producer warp
constexpr int kF90Consumers = 256;
constexpr int kF90Half = 128 * 128;  // bytes: 128 rows x 64 bf16 columns
// a 128 x D bf16 tile (D / 64 halves), and a block's dynamic shared memory
// (barriers, Q and the ring, + alignment slack)
template <int D>
__host__ __device__ constexpr int f90_tile() {
  return D / 64 * kF90Half;
}
template <int D>
__host__ __device__ constexpr int f90_smem() {
  return 1024 + f90_tile<D>() * (1 + 2 * kF90Stages) + 1024;
}
static_assert(f90_smem<128>() <= 232448, "more shared memory than a block may have");
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct F90Args {
  const int32_t *offsets, *kv_lens;
  __nv_bfloat16* out;
  float* lse;
  int sq, skv, hq, groups, n_qt;
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
  int causal;
};

template <int D>
__device__ __forceinline__ void sm90_fwd(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                         const CUtensorMap* vmap, const F90Args& a,
                                         uint8_t* smem_raw) {
  static_assert(D == 64 || D == 128, "the sm90 forward takes D = 64 or 128");
  constexpr int kHalves = D / 64;
  constexpr int kTile = f90_tile<D>();
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kF90Stages;
  uint8_t* qs = smem + 1024;
  uint8_t* kvs = qs + kTile;  // stage s: K at kvs + 2s tiles, V right after

  const int h = blockIdx.x, b = blockIdx.y, hk = h / a.groups;
  // longest first: under the causal mask the last q tiles see the most keys
  const int qt = a.causal ? a.n_qt - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int q0 = qt * kF90BlockM;
  const int offset = a.offsets[b];
  const int kv_len = min(max(a.kv_lens[b], 0), a.skv);
  int hi = (kv_len + kF90BlockN - 1) / kF90BlockN;
  if (a.causal) hi = min(hi, max(0, (offset + q0 + kF90BlockM + kF90BlockN - 1) / kF90BlockN));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  GOFR_DCHECK((int)gridDim.x == a.hq && (int)gridDim.z == a.n_qt);
  GOFR_DCHECK(qt >= 0 && qt < a.n_qt && q0 < a.sq);
  GOFR_DCHECK(hk * a.groups <= h && kv_len <= a.skv && hi <= (a.skv + kF90BlockN - 1) / kF90BlockN);

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kF90Stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kF90Consumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kF90Consumers / 32) {  // the producer warpgroup; warp 8 loads
    regs_dealloc<24>();
    if (warp == kF90Consumers / 32 && lane == 0 && hi > 0) {
      mbar_arrive_expect_tx(q_full, kTile);
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) {
        tma_load_4d(qs + hf * kF90Half, qmap, q_full, hf * 64, h, q0, b);
      }
      for (int j = 0; j < hi; ++j) {
        const int s = j % kF90Stages;
        mbar_wait(&empty[s], ((j / kF90Stages) & 1) ^ 1);
        uint8_t* ks = kvs + 2 * s * kTile;
        uint8_t* vs = ks + kTile;
        mbar_arrive_expect_tx(&full[s], 2 * kTile);
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          tma_load_4d(ks + hf * kF90Half, kmap, &full[s], hf * 64, hk, j * kF90BlockN, b);
        }
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          tma_load_4d(vs + hf * kF90Half, vmap, &full[s], hf * 64, hk, j * kF90BlockN, b);
        }
      }
    }
    return;
  }

  regs_alloc<240>();
  const int wg = warp / 4, g = lane / 4, t = lane % 4;
  const int row_in = wg * 64 + (warp % 4) * 16 + g;  // this thread's rows: row_in, row_in + 8
  const int qpos0 = offset + q0 + row_in;
  const int wg_first = offset + q0 + wg * 64;  // the warpgroup's first q position
  const uint32_t q_addr = smem_u32(qs) + wg * 64 * 128;

  float o[D / 2], sc[64];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's share; the quad's sum at the end
  if (hi > 0) mbar_wait(q_full, 0);

  for (int j = 0; j < hi; ++j) {
    const int s = j % kF90Stages;
    const int k0 = j * kF90BlockN;
    GOFR_DCHECK(k0 < kv_len);
    mbar_wait(&full[s], (j / kF90Stages) & 1);
    uint8_t* vs = kvs + (2 * s + 1) * kTile;
    const uint32_t k_addr = smem_u32(kvs + 2 * s * kTile), v_addr = smem_u32(vs);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kF90Half + (kk % 4) * 32;
      wgmma_m64n128k16_ss(sc, smem_desc(q_addr + off, 16, 1024), smem_desc(k_addr + off, 16, 1024),
                          kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    if (k0 + kF90BlockN > kv_len) {
      // the tile holds keys at or past kv_len: TMA loaded whatever the cache
      // holds there, and 0 * NaN is NaN, so zero those V rows before P.V
      const int first = kv_len - k0;
      GOFR_DCHECK(first > 0 && first < kF90BlockN);
      for (int c = tid; c < (kF90BlockN - first) * (D / 8); c += kF90Consumers) {
        const int r = first + c / (D / 8), half = (c / 8) % kHalves, chunk = c % 8;
        GOFR_DCHECK(r < kF90BlockN);
        *reinterpret_cast<uint4*>(vs + half * kF90Half + r * 128 + chunk * 16) =
            make_uint4(0, 0, 0, 0);
      }
      fence_proxy_async();
      named_bar_sync(1, kF90Consumers);
    }

    const bool need_mask = k0 + kF90BlockN > kv_len || (a.causal && k0 + kF90BlockN - 1 > wg_first);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * i + e] * a.scale_log2;
        if (need_mask) {
          const int kpos = k0 + 8 * i + 2 * t + (e & 1);
          const bool valid = kpos < kv_len && (!a.causal || kpos <= qpos0 + (e >> 1) * 8);
          x = valid ? x : kNegInf;
        }
        sc[4 * i + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2_fast(m_run[r] - mx[r]);
      m_run[r] = mx[r];
      l_run[r] *= alpha[r];
    }
    // P in the A layout of P.V: score n-tiles 2i and 2i + 1 are k-step i
    uint32_t pf[8][4];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked keys contribute exactly 0, never exp(-1e30 - m)
        const float x = sc[4 * i + e];
        p[e] = x > 0.5f * kNegInf ? exp2_fast(x - m_run[e >> 1]) : 0.f;
        l_run[e >> 1] += p[e];
      }
      pf[i / 2][(i & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[i / 2][(i & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n + 0] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t v_desc = smem_desc(v_addr + kk * 16 * 128, kF90Half, 1024);
      if constexpr (D == 128) {
        wgmma_m64n128k16_rs_tb(o, pf[kk], v_desc);
      } else {
        wgmma_m64n64k16_rs_tb(o, pf[kk], v_desc);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pf);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int64_t out_ss = (int64_t)a.hq * D;  // out is [B, Sq, Hq, D] contiguous
  __nv_bfloat16* ob = a.out + (int64_t)b * a.sq * out_ss + (int64_t)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row_in + r * 8;
    if (row >= a.sq) continue;
    const float inv = 1.f / (l_run[r] == 0.f ? 1.f : l_run[r]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(ob + row * out_ss + n * 8 + 2 * t) =
          pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    }
    if (t == 0) {
      a.lse[((int64_t)b * a.hq + h) * a.sq + row] =
          l_run[r] > 0.f ? (m_run[r] + log2f(l_run[r])) * kLn2 : INFINITY;
    }
  }
}

// the two instances, each under its own name in ptxas's report
__global__ void __launch_bounds__(kF90Threads, 1) flash_fwd_sm90_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, F90Args a) {
  extern __shared__ uint8_t f90_smem_raw[];
  sm90_fwd<128>(&qmap, &kmap, &vmap, a, f90_smem_raw);
}

__global__ void __launch_bounds__(kF90Threads, 1) flash_fwd_sm90_d64_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, F90Args a) {
  extern __shared__ uint8_t f90_smem_raw[];
  sm90_fwd<64>(&qmap, &kmap, &vmap, a, f90_smem_raw);
}

// ---------------------------------- bf16, D = 128, Sq x groups <= 32: decode

// One block per (split, KV head, batch row); the `splits` blocks of one
// (KV head, batch row) are one thread block cluster along x.
// - The Sq x groups query rows of the KV head (the q heads of its GQA
//   group at each q position, row r = s * groups + gi) are packed into R
//   m16 row tiles: K and V are read once per KV head, not once per q head,
//   whatever the width.
// - R = 1 (up to 16 rows: decode, and verify widths up to 4 at llama3-8b's
//   groups of 4) is a block of 128 threads; R = 2 (17-32 rows: speculation's
//   verify at widths 5-8) gives each row tile its own four warps, a block of
//   256. Warp w takes row tile w / 4 and keys 16 (w % 4) of each tile, with
//   the registers of the R = 1 kernel (its Q fragments, a 16 x 128 partial
//   O): both row tiles read the same K/V ring, so the bytes stay the bound's.
//   Two m16 tiles of four warps each, not one m64 wgmma tile over the
//   packed rows: the mma.sync loop is the R = 1 kernel's, already at 0
//   spills, and a wgmma m64 tile would compute 64 rows for 20-32.
// - The keys any row may see, [0, min(kv_len, causal: q_offset + Sq)),
//   are cut into 64-key tiles, and split s takes tiles [s * per, (s + 1) *
//   per) with per = cdiv(tiles, splits): every block finds its own range
//   from its row's kv_len on the device, so the host reads no device value.
//   Keys past the range are never read (cp.async writes zeros there).
// - A two-stage cp.async ring of K/V tiles keeps bytes in flight; each
//   warp computes S = Q.K^T and O += P.V on its 16 keys by mma.sync
//   m16n8k16, and its own online softmax (m, l, O) in base 2.
//   Two stages (68 KB) let three R = 1 blocks share an SM, which on the H100
//   was faster at batch 4 than three or four stages and about even at
//   batch 1. (One 256-byte bulk copy a row through the TMA unit was slower
//   than cp.async here: a tile is 128 such copies.)
// - The merge: each block first merges its four key slices' (m, l, O) per
//   row in shared memory (the ring's memory, or more: R = 2's partials,
//   86 KB, outgrow its 68 KB ring); after a cluster barrier each block reads
//   its share of the (row, column) outputs from every block of the cluster
//   through distributed shared memory and sums them in split order:
//   deterministic, no atomics. A partial with l = 0 (no visible key) weighs
//   exactly 0, and a row with no key at all gets out 0 and LSE +inf.
constexpr int kDecTileRows = 16;  // one m16 row tile
constexpr int kDecRows = 32;  // packed query rows: at most two m16 row tiles
constexpr int kDecThreads = 128;  // a row tile's warps
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecBlockN = 16 * kDecWarps;  // keys per tile, 16 per warp
constexpr int kDecStages = 2;      // 68 KB a block: three R = 1 blocks an SM
constexpr int kDecMaxSplits = 8;  // the portable thread block cluster size
constexpr int kDecLd = 136;       // bf16 row pitch of a K/V tile (+16 bytes: no bank conflicts)
constexpr int kDecTile = kDecBlockN * kDecLd;  // elements of one K or V tile
constexpr int kDecOLd = 136;                   // f32 row pitch of a partial O
constexpr int kDecRing = kDecStages * 2 * kDecTile * 2;  // bytes
// the partials of R row tiles: each key slice's (m, l, O), then the
// block's; and a block's dynamic shared memory
template <int R>
__host__ __device__ constexpr int dec_parts() {  // floats
  return (kDecWarps + 1) * R * kDecTileRows * (kDecOLd + 2);
}
template <int R>
__host__ __device__ constexpr int dec_smem() {
  return kDecRing > dec_parts<R>() * 4 ? kDecRing : dec_parts<R>() * 4;
}

struct DecArgs {
  const __nv_bfloat16 *q, *k, *v;
  const int32_t *offsets, *kv_lens;
  __nv_bfloat16* out;
  float* lse;
  int sq, skv, hq, groups, splits;
  Strides st;
  float scale_log2;  // scale * log2(e): the softmax runs in base 2
  int causal;
};

template <int R>
__device__ __forceinline__ void decode_fwd(const DecArgs& a, uint8_t* dec_smem) {
  constexpr int kThreadsR = R * kDecThreads;
  constexpr int kRowsR = R * kDecTileRows;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(dec_smem);  // stage s: K, then V

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int kw = warp % kDecWarps;  // this warp's 16 keys of each tile
  const int rt = warp / kDecWarps;  // this warp's row tile
  const int rows = a.sq * a.groups;
  const int offset = a.offsets[b];
  const int kv_len = min(max(a.kv_lens[b], 0), a.skv);
  // this split's keys: [t_lo * 64, k_hi)
  const int kv_end = a.causal ? min(kv_len, max(0, offset + a.sq)) : kv_len;
  const int n_tiles = (kv_end + kDecBlockN - 1) / kDecBlockN;
  const int per = (n_tiles + a.splits - 1) / a.splits;
  const int t_lo = split * per;
  const int nt = max(0, min(t_lo + per, n_tiles) - t_lo);
  const int k_hi = min((t_lo + nt) * kDecBlockN, kv_end);
  GOFR_DCHECK((int)gridDim.x == a.splits && split < a.splits && rows <= kRowsR);
  GOFR_DCHECK(kv_end <= kv_len && kv_len <= a.skv && k_hi <= kv_end && (nt == 0 || t_lo < n_tiles));
  const Strides& st = a.st;
  const __nv_bfloat16* kb = a.k + b * st.kb + hk * st.kh;
  const __nv_bfloat16* vb = a.v + b * st.vb + hk * st.vh;

  // 16 bytes a thread; rows at or past k_hi are zero-filled, never read
  auto load_tile = [&](int j, int stage) {
    const int k0 = (t_lo + j) * kDecBlockN;
    __nv_bfloat16* ks = ring + stage * 2 * kDecTile;
    for (int c = tid; c < 2 * kDecBlockN * 16; c += kThreadsR) {
      const int which = c / (kDecBlockN * 16), r = (c / 16) % kDecBlockN, chunk = c % 16;
      const int pos = k0 + r;
      const bool live = pos < k_hi;
      GOFR_DCHECK(!live || (pos >= t_lo * kDecBlockN && pos < a.skv));
      const __nv_bfloat16* src = which ? vb + (int64_t)(live ? pos : 0) * st.vs
                                       : kb + (int64_t)(live ? pos : 0) * st.ks;
      cp_async_16(ks + which * kDecTile + r * kDecLd + chunk * 8, src + chunk * 8, live ? 16 : 0);
    }
  };

  // the ring's first tiles are in flight before anything else is read
#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < nt) load_tile(s, s);
    cp_async_commit();
  }

  // Q fragments of the packed rows rt * 16 + g and + 8 (zeros past the
  // last row); the four warps of a row tile hold the same 16 rows
  uint32_t qf[8][4];
  int lim[2];  // the last key position each of this thread's rows may see
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = rt * kDecTileRows + g + rr * 8;
    const int s = row / a.groups, h = hk * a.groups + row % a.groups;
    lim[rr] = a.causal ? offset + s : INT_MAX;
    const __nv_bfloat16* qrow = a.q + b * st.qb + s * st.qs + h * st.qh;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = kk * 16 + half * 8 + 2 * t;
        qf[kk][half * 2 + rr] = row < rows ? pack_raw(qrow[col], qrow[col + 1]) : 0u;
      }
    }
  }

  float o[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  for (int j = 0; j < nt; ++j) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();  // tile j is in for every thread; tile j - 1's stage is free
    if (j + kDecStages - 1 < nt) load_tile(j + kDecStages - 1, (j + kDecStages - 1) % kDecStages);
    cp_async_commit();

    const __nv_bfloat16* ks = ring + (j % kDecStages) * 2 * kDecTile + kw * 16 * kDecLd;
    const __nv_bfloat16* vs = ks + kDecTile;
    const int k0 = (t_lo + j) * kDecBlockN + kw * 16;  // this warp's 16 keys
    float sc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      const __nv_bfloat16* krow = ks + (n * 8 + g) * kDecLd + 2 * t;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        mma_16816(sc[n], qf[kk], *reinterpret_cast<const uint32_t*>(krow + kk * 16),
                  *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8));
      }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        const bool valid = kpos < k_hi && kpos <= lim[e >> 1];
        sc[n][e] = valid ? sc[n][e] * a.scale_log2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2_fast(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
    // P in the A layout of P.V: score n-tiles 0 and 1 are the one k-step
    uint32_t pf[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked keys contribute exactly 0, never exp(-1e30 - m)
        p[e] = sc[n][e] > 0.5f * kNegInf ? exp2_fast(sc[n][e] - m_run[e >> 1]) : 0.f;
        rsum[e >> 1] += p[e];
      }
      pf[n * 2 + 0] = pack_bf16(p[0], p[1]);
      pf[n * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l_run[r] = alpha[r] * l_run[r] + rsum[r];
    }
    const __nv_bfloat16* v0 = vs + (2 * t) * kDecLd + g;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
      const __nv_bfloat16* vc = v0 + n * 8;
      mma_16816(o[n], pf, pack_raw(vc[0], vc[kDecLd]), pack_raw(vc[8 * kDecLd], vc[9 * kDecLd]));
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every tile consumed: the ring's memory takes the partials

  float* part_o = reinterpret_cast<float*>(dec_smem);  // [key slice][row][kDecOLd]
  float* part_m = part_o + kDecWarps * kRowsR * kDecOLd;  // [key slice][row]
  float* part_l = part_m + kDecWarps * kRowsR;
  float* blk_o = part_l + kDecWarps * kRowsR;  // the block's: [row][kDecOLd]
  float* blk_m = blk_o + kRowsR * kDecOLd;  // [row]
  float* blk_l = blk_m + kRowsR;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kw * kRowsR + rt * kDecTileRows + g + 8 * r;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      *reinterpret_cast<float2*>(part_o + row * kDecOLd + n * 8 + 2 * t) =
          make_float2(o[n][2 * r], o[n][2 * r + 1]);
    }
    if (t == 0) {
      part_m[row] = m_run[r];
      part_l[row] = l_run[r];
    }
  }
  __syncthreads();
  // the block's partial from its four key slices': (m, l, O) with O
  // relative to m. A partial with l = 0 (no visible key) weighs exactly 0.
  for (int u = tid; u < rows * 64; u += kThreadsR) {
    const int row = u / 64, c = (u % 64) * 2;
    float m_b = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      if (part_l[w * kRowsR + row] > 0.f) m_b = fmaxf(m_b, part_m[w * kRowsR + row]);
    }
    float l_b = 0.f, ox = 0.f, oy = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {  // a fixed order: deterministic
      const float l_w = part_l[w * kRowsR + row];
      if (l_w > 0.f) {
        const float x = exp2_fast(part_m[w * kRowsR + row] - m_b);
        const float2 o_w =
            *reinterpret_cast<const float2*>(part_o + (w * kRowsR + row) * kDecOLd + c);
        l_b += l_w * x;
        ox += o_w.x * x;
        oy += o_w.y * x;
      }
    }
    *reinterpret_cast<float2*>(blk_o + row * kDecOLd + c) = make_float2(ox, oy);
    if (c == 0) {
      blk_m[row] = m_b;
      blk_l[row] = l_b;
    }
  }
  __syncwarp();
  cluster_sync();

  // this block's share of the (row, column pair) outputs, summed over the
  // cluster's blocks through distributed shared memory in split order
  const int units = rows * 64;
  const int u_per = (units + a.splits - 1) / a.splits;
  const int u_end = min((split + 1) * u_per, units);
  for (int u = split * u_per + tid; u < u_end; u += kThreadsR) {
    const int row = u / 64, c = (u % 64) * 2;
    float2 po[kDecMaxSplits];  // all loads in flight at once, then the sum
    float pm[kDecMaxSplits], pl[kDecMaxSplits];
#pragma unroll
    for (int i = 0; i < kDecMaxSplits; ++i) {
      if (i < a.splits) {
        po[i] = ld_dsmem_f2(blk_o + row * kDecOLd + c, i);
        pm[i] = ld_dsmem_f32(blk_m + row, i);
        pl[i] = ld_dsmem_f32(blk_l + row, i);
      }
    }
    float m_all = kNegInf;
#pragma unroll
    for (int i = 0; i < kDecMaxSplits; ++i) {
      if (i < a.splits && pl[i] > 0.f) m_all = fmaxf(m_all, pm[i]);
    }
    float l_all = 0.f, ox = 0.f, oy = 0.f;
#pragma unroll
    for (int i = 0; i < kDecMaxSplits; ++i) {  // a fixed order: deterministic
      if (i < a.splits && pl[i] > 0.f) {
        const float x = exp2_fast(pm[i] - m_all);
        l_all += pl[i] * x;
        ox += po[i].x * x;
        oy += po[i].y * x;
      }
    }
    const float inv = l_all > 0.f ? 1.f / l_all : 0.f;
    const int s = row / a.groups, h = hk * a.groups + row % a.groups;
    GOFR_DCHECK(row < rows && s < a.sq && h < a.hq);
    const int64_t q_row = (int64_t)b * a.sq + s;  // out is [B, Sq, Hq, D] contiguous
    *reinterpret_cast<uint32_t*>(a.out + (q_row * a.hq + h) * 128 + c) =
        pack_bf16(ox * inv, oy * inv);
    if (c == 0) {
      a.lse[((int64_t)b * a.hq + h) * a.sq + s] =
          l_all > 0.f ? (m_all + log2f(l_all)) * kLn2 : INFINITY;
    }
  }
  __syncwarp();
  cluster_sync();  // no block leaves while another reads its shared memory
}

// the two instances, each under its own name in ptxas's report
__global__ void __launch_bounds__(kDecThreads) flash_fwd_decode_kernel(DecArgs a) {
  extern __shared__ __align__(16) uint8_t dec_smem[];
  decode_fwd<1>(a, dec_smem);
}

__global__ void __launch_bounds__(2 * kDecThreads) flash_fwd_decode_r2_kernel(DecArgs a) {
  extern __shared__ __align__(16) uint8_t dec_smem[];
  decode_fwd<2>(a, dec_smem);
}

// ----------------------------------------------------------------- f32 path

constexpr int kBlockQ = 16;
constexpr int kBlockKV = 32;  // one key per lane

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ kv_lens,
    float* __restrict__ out, float* __restrict__ lse, int sq, int skv, int hq, int groups,
    Strides st, float scale, int causal) {
  // +1 float per row: lane-strided row reads hit 32 distinct banks
  constexpr int LD = D + 1;
  constexpr int kRowsPerWarp = kBlockQ / kWarps;  // score rows per warp
  constexpr int kRowGroups = kThreads / D;        // P.V: threads per column
  constexpr int kAccRows = kBlockQ / kRowGroups;  // P.V rows per thread
  static_assert(kThreads % D == 0 && kBlockQ % kRowGroups == 0, "tile shape");

  __shared__ float qs[kBlockQ * LD];
  __shared__ float ks[kBlockKV * LD];
  __shared__ float vs[kBlockKV * LD];
  __shared__ float ps[kBlockQ * kBlockKV];
  __shared__ float row_alpha[kBlockQ];
  __shared__ float row_m[kBlockQ];
  __shared__ float row_l[kBlockQ];

  const int h = blockIdx.y, b = blockIdx.z, hk = h / groups;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBlockQ;
  const int offset = offsets[b];
  const int kv_len = min(max(kv_lens[b], 0), skv);
  GOFR_DCHECK(q0 < sq && h < hq && kv_len <= skv);

  const float* qb = q + b * st.qb + h * st.qh;
  const float* kb = k + b * st.kb + hk * st.kh;
  const float* vb = v + b * st.vb + hk * st.vh;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int row = q0 + r;
    qs[r * LD + c] = row < sq ? qb[row * st.qs + c] : 0.f;
  }

  int hi = (kv_len + kBlockKV - 1) / kBlockKV;
  if (causal) {
    const int last_q = offset + q0 + kBlockQ;  // exclusive
    hi = min(hi, max(0, (last_q + kBlockKV - 1) / kBlockKV));
  }

  float m_run[kRowsPerWarp];
  float l_run[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
  }
  const int dcol = tid % D;
  const int rgroup = tid / D;
  float acc[kAccRows];
#pragma unroll
  for (int i = 0; i < kAccRows; ++i) acc[i] = 0.f;

  for (int j = 0; j < hi; ++j) {
    const int k0 = j * kBlockKV;
    __syncthreads();  // the previous tile's ks/vs/ps are consumed
    for (int e = tid; e < kBlockKV * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int pos = k0 + r;
      const bool live = pos < kv_len;  // never read past the written prefix
      ks[r * LD + c] = live ? kb[pos * st.ks + c] : 0.f;
      vs[r * LD + c] = live ? vb[pos * st.vs + c] : 0.f;
    }
    __syncthreads();

    // scores: warp w owns rows w, w + 4, ...; lane owns key k0 + lane
    const int kpos = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * kWarps;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qs[r * LD + d], ks[lane * LD + d], s);
      s *= scale;
      const int qpos = offset + q0 + r;
      const bool valid = kpos < kv_len && (!causal || kpos <= qpos);
      s = valid ? s : kNegInf;
      const float m_new = fmaxf(m_run[i], warp_max(s));
      const float alpha = expf(m_run[i] - m_new);
      const float p = valid ? expf(s - m_new) : 0.f;
      l_run[i] = alpha * l_run[i] + warp_sum(p);
      m_run[i] = m_new;
      ps[r * kBlockKV + lane] = p;
      if (lane == 0) row_alpha[r] = alpha;
    }
    __syncthreads();

    // acc[r, d] = alpha_r * acc[r, d] + sum_c P[r, c] * V[c, d]
#pragma unroll
    for (int i = 0; i < kAccRows; ++i) {
      const int r = rgroup + i * kRowGroups;
      float a = acc[i] * row_alpha[r];
#pragma unroll 8
      for (int c = 0; c < kBlockKV; ++c) a = fmaf(ps[r * kBlockKV + c], vs[c * LD + dcol], a);
      acc[i] = a;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * kWarps;
      row_m[r] = m_run[i];
      row_l[r] = l_run[i];
    }
  }
  __syncthreads();

  const int64_t out_ss = (int64_t)hq * D;  // out is [B, Sq, Hq, D] contiguous
  float* ob = out + (int64_t)b * sq * out_ss + (int64_t)h * D;
#pragma unroll
  for (int i = 0; i < kAccRows; ++i) {
    const int r = rgroup + i * kRowGroups;
    const int row = q0 + r;
    if (row < sq) {
      const float l = row_l[r];
      ob[row * out_ss + dcol] = acc[i] / (l == 0.f ? 1.f : l);
    }
  }
  if (tid < kBlockQ) {
    const int row = q0 + tid;
    if (row < sq) {
      const float l = row_l[tid];
      lse[((int64_t)b * hq + h) * sq + row] = l > 0.f ? row_m[tid] + logf(l) : INFINITY;
    }
  }
}

// ------------------------------------------------------------------ launch

struct Args {
  const void *q, *k, *v;
  const int32_t *offsets, *kv_lens;
  void* out;
  float* lse;
  int b, sq, skv, hq, hkv;
  Strides st;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D>
void launch_bf16(const Args& a) {
  dim3 grid((a.sq + kMmaBlockQ - 1) / kMmaBlockQ, a.hq, a.b);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.offsets, a.kv_lens,
      static_cast<__nv_bfloat16*>(a.out), a.lse, a.sq, a.skv, a.hq, a.hq / a.hkv, a.st,
      a.scale, a.causal);
}

template <int D>
void launch_f32(const Args& a) {
  dim3 grid((a.sq + kBlockQ - 1) / kBlockQ, a.hq, a.b);
  flash_fwd_f32_kernel<D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.offsets, a.kv_lens, static_cast<float*>(a.out), a.lse,
      a.sq, a.skv, a.hq, a.hq / a.hkv, a.st, a.scale, a.causal);
}

int dispatch(int dtype, int d, const Args& a) {
  if (dtype == 0) {
    switch (d) {
      case 16: launch_f32<16>(a); break;
      case 32: launch_f32<32>(a); break;
      case 64: launch_f32<64>(a); break;
      case 128: launch_f32<128>(a); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (dtype == 1) {
    switch (d) {
      case 16: launch_bf16<16>(a); break;
      case 32: launch_bf16<32>(a); break;
      case 64: launch_bf16<64>(a); break;
      case 128: launch_bf16<128>(a); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_sm90(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                const F90Args& a, dim3 grid, cudaStream_t stream) {
  auto kernel = D == 128 ? flash_fwd_sm90_kernel : flash_fwd_sm90_d64_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, f90_smem<D>());
  if (err != cudaSuccess) return (int)err;
  if constexpr (D == 128) {
    flash_fwd_sm90_kernel<<<grid, kF90Threads, f90_smem<D>(), stream>>>(qm, km, vm, a);
  } else {
    flash_fwd_sm90_d64_kernel<<<grid, kF90Threads, f90_smem<D>(), stream>>>(qm, km, vm, a);
  }
  return (int)cudaGetLastError();
}

template <int R>
int launch_decode(const DecArgs& a, int hkv, int b, cudaStream_t stream) {
  auto kernel = R == 1 ? flash_fwd_decode_kernel : flash_fwd_decode_r2_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dec_smem<R>());
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, hkv, b);
  cfg.blockDim = dim3(R * kDecThreads);
  cfg.dynamicSmemBytes = dec_smem<R>();
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = a.splits;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for the
// batch, sequence and head dims of q, k and v in that order; for bf16, k
// and v rows must be 16-byte aligned (pointers and strides). Returns the
// launch's cudaGetLastError() (0 on success).
int gofr_flash_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                   const void* offsets, const void* kv_lens, void* out, void* lse,
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
  a.offsets = static_cast<const int32_t*>(offsets);
  a.kv_lens = static_cast<const int32_t*>(kv_lens);
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.b = b;
  a.sq = sq;
  a.skv = skv;
  a.hq = hq;
  a.hkv = hkv;
  a.st = Strides{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  a.scale = scale;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, head_dim, a);
}

// The sm90 variant (bf16, D = 64 or 128, Sq >= 64; the caller picks it).
// q, k and v rows must be 16-byte aligned (pointers and strides: TMA reads
// them). grid is (Hq, B, cdiv(Sq, 128)), the q tiles launched longest first
// when causal; ops/flash.py::fwd_sm90_grid computes it. Returns a
// cudaError_t value (0 on success).
int gofr_flash_fwd_sm90(int head_dim, const void* q, const void* k, const void* v,
                        const void* offsets, const void* kv_lens, void* out, void* lse,
                        int b, int sq, int skv, int hq, int hkv,
                        int64_t qsb, int64_t qss, int64_t qsh,
                        int64_t ksb, int64_t kss, int64_t ksh,
                        int64_t vsb, int64_t vss, int64_t vsh,
                        float scale, int causal, int grid_x, int grid_y, int grid_z,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (grid_x != hq || grid_y != b || grid_z != (sq + kF90BlockM - 1) / kF90BlockM || sq < 1 ||
      hkv < 1 || hq % hkv || (head_dim != 64 && head_dim != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap qm, km, vm;
  int rc = make_bf16_map(&qm, q, b, sq, hq, head_dim, qsb, qss, qsh, kF90BlockM);
  if (rc == 0) rc = make_bf16_map(&km, k, b, skv, hkv, head_dim, ksb, kss, ksh, kF90BlockN);
  if (rc == 0) rc = make_bf16_map(&vm, v, b, skv, hkv, head_dim, vsb, vss, vsh, kF90BlockN);
  if (rc != 0) return rc;
  F90Args a;
  a.offsets = static_cast<const int32_t*>(offsets);
  a.kv_lens = static_cast<const int32_t*>(kv_lens);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse = static_cast<float*>(lse);
  a.sq = sq;
  a.skv = skv;
  a.hq = hq;
  a.groups = hq / hkv;
  a.n_qt = grid_z;
  a.scale_log2 = scale * kLog2e;
  a.causal = causal;
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return head_dim == 128 ? launch_sm90<128>(qm, km, vm, a, grid, st)
                         : launch_sm90<64>(qm, km, vm, a, grid, st);
}

// The decode variant (bf16, D = 128, Sq x (Hq / Hkv) <= 32; the caller
// picks it): the one-row-tile instance up to 16 packed rows, the two-tile
// instance past them. k and v rows must be 16-byte aligned (pointers and
// strides: cp.async reads them 16 bytes at a time). The grid is (splits,
// Hkv, B) in clusters of `splits` <= 8 blocks along x; ops/flash.py::
// fwd_decode_splits computes `splits` from B, Hkv and Skv. Returns a
// cudaError_t value (0 on success).
int gofr_flash_fwd_decode(const void* q, const void* k, const void* v, const void* offsets,
                          const void* kv_lens, void* out, void* lse,
                          int b, int sq, int skv, int hq, int hkv,
                          int64_t qsb, int64_t qss, int64_t qsh,
                          int64_t ksb, int64_t kss, int64_t ksh,
                          int64_t vsb, int64_t vss, int64_t vsh,
                          float scale, int causal, int splits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hkv < 1 || hq % hkv || sq < 1 || skv < 1 || sq * (hq / hkv) > kDecRows || splits < 1 ||
      splits > kDecMaxSplits) {
    return (int)cudaErrorInvalidValue;
  }
  DecArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.kv_lens = static_cast<const int32_t*>(kv_lens);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse = static_cast<float*>(lse);
  a.sq = sq;
  a.skv = skv;
  a.hq = hq;
  a.groups = hq / hkv;
  a.splits = splits;
  a.st = Strides{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  a.scale_log2 = scale * kLog2e;
  a.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return sq * a.groups > kDecTileRows ? launch_decode<2>(a, hkv, b, st)
                                      : launch_decode<1>(a, hkv, b, st);
}

const char* gofr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of a block of each instance of the sm90 and decode
// variants, in bytes.
int gofr_flash_fwd_sm90_smem() { return f90_smem<128>(); }
int gofr_flash_fwd_sm90_d64_smem() { return f90_smem<64>(); }
int gofr_flash_fwd_decode_smem() { return dec_smem<1>(); }
int gofr_flash_fwd_decode_r2_smem() { return dec_smem<2>(); }

}  // extern "C"
