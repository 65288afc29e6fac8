// Flash attention for Hopper (sm_90a): forward (plain, train and state
// modes), backward dQ and backward dK/dV, written by hand in CUDA C++.
//
// Replaces the five Pallas kernels of horovod_tpu/ops/pallas_attention.py:
//   flash_fwd      <- _attn_kernel (45) via _pallas_attention_fwd (602,
//                     plain mode: O), _pallas_attention_fwd_train (653,
//                     train mode: O + lse) and _pallas_block_state (343,
//                     pallas_call 391, state mode: the unnormalized fp32
//                     accumulator + m + l that ring attention merges)
//   flash_bwd_dq   <- _attn_bwd_dq_kernel (182) via _pallas_bwd (737)
//   flash_bwd_dkv  <- _attn_bwd_dkv_kernel (246) via _pallas_bwd (770)
// Every kernel takes optional packed-sequence segment ids (the `_seg`
// variants at 157, 174, 237, 307, 595), and the two backward kernels write
// their outputs in the input dtype or in fp32 (`_pallas_bwd`'s out_dtype,
// which ring attention's backward uses to sum blocks in fp32).
//
// Layout: q/k/v/dO are [B, T, H, D] tensors read by strides (the head dim
// is contiguous; b/t/h strides are multiples of 16 bytes), so no
// [B*H, T, D] copy is made. lse, delta, m and l are fp32 [B, H, Tq]
// contiguous; segment ids are int32 [B, Tq] and [B, Tk] contiguous, one
// row per batch entry (no per-head copy). Outputs are written through
// their own strides. A ragged last tile is zero-filled and masked inside
// the kernels, so every T is served. Causal and sliding-window tiles that
// hold no visible key are culled before they are loaded (the Pallas
// predicate); segment ids mask pairs inside a tile and never cull one, and
// are a template flag (SEG), so a call without them runs no id code. In
// state mode a block whose every tile is culled (a future block of the
// ring) still writes m = -1e30, l = 0 and acc = 0, the state the merge
// expects.
//
// Bounds on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s). At the slice's
// shape (B=8, T=1024, H=12, D=64, causal, bf16, one layer) the forward
// needs ~12.9 GFLOP over the visible pairs (13 us) and moves ~50 MB
// (15 us): bound by bytes; dQ needs 1.5 times its operations (20 us) and
// dK/dV twice (26 us) over ~76 MB. At the ring's past block (Tq = Tk =
// 2048, every pair visible) the state mode needs ~103 GFLOP (104 us), dQ
// with an fp32 output ~155 GFLOP (156 us) and dK/dV ~206 GFLOP (208 us):
// all bound by operations.
//
// bf16 inputs run three kernels of one design: flash_fwd_sm90 (every
// forward mode), flash_bwd_dq_sm90 and flash_bwd_dkv_sm90. Each CTA is
// three warpgroups: two consumers of 64 rows each and one producer. What
// the design does about what bounds attention on this card:
//  1. Products run as wgmma with fp32 accumulators in registers. The score
//     tiles (S = Q.K^T; dQ also dP = dO.V^T; dK/dV S^T = K.Q^T and dP^T =
//     V.dO^T) read both operands from shared memory, K-major. P (dQ: dS;
//     dK/dV: P^T and dS^T), rounded to bf16 where the Pallas kernels round
//     it, is the register A operand of the next product (O += P.V,
//     dQ += dS.K, dV += P^T.dO, dK += dS^T.Q), whose B operand is read
//     MN-major by the descriptor's transpose: dQ reads one K tile both
//     ways. O, dQ, dK and dV never leave registers until the epilogue, and
//     no score tile goes through shared memory.
//  2. Loads are asynchronous: the CTA's own rows (forward: Q; dQ: Q and
//     dO; dK/dV: K and V) arrive once by TMA into 128-byte-swizzled shared
//     memory; the streamed tiles (K/V and, with SEG, their ids; dK/dV: Q,
//     dO and the rows' lse, delta and ids) pass through a ring of two
//     stages that one producer warp fills while the consumers compute on
//     the other stage, with full/empty mbarriers between them.
//  3. Shared memory holds only bf16 tiles and ids: the forward a 128-row Q
//     tile and two stages of 128-key K/V tiles (80 KB at D=64, 160 KB at
//     D=128); dQ 128-row Q and dO tiles and two stages of K/V tiles of 128
//     keys at D=64, 64 at D=128 (96 KB and 128 KB); dK/dV a 128-key K/V
//     tile and two stages of 64-row Q/dO tiles (64 KB and 128 KB). The
//     producer gives up its registers (setmaxnreg) so the consumers hold
//     their accumulators; dQ's key tile is halved at D=128 so that dQ, S,
//     dP and the dS fragments fit in them without spilling.
//  4. Exponentials run in the log2 domain: scores are scaled by
//     scale * log2(e) in one multiply and exponentiated with exp2f (the
//     backward kernels scale each row's lse by log2(e) once); the
//     forward's row max and sum are reduced across the four lanes of a row
//     by shuffles.
//  5. Tile culling is an index range computed once (no per-tile test);
//     tiles wholly visible to a warpgroup skip the per-element mask; the
//     causal forward and dQ launch their heaviest (last) query tiles
//     first; a kernel's shared-memory attribute is set once per device.
//
// fp32 inputs keep a simpler design by choice (fp32 stays fp32, with no
// TF32 rounding; the model runs in bf16): one CTA owns one 64-row tile (32
// rows at D=128) and loops over the tiles of the other dimension, each
// warp a 16-row strip of every per-tile matrix, its products an FMA loop
// through shared memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, t, h;  // element strides of a [B, T, H, D] tensor
};

// One fp32 output row of D values from a fp32 shared row.
template <int D>
__device__ __forceinline__ void store_row(float* row, const float* src, int lane) {
  for (int d = lane; d < D; d += 32) row[d] = src[d];
}

__host__ __device__ constexpr int align128(int x) { return (x + 127) & ~127; }

// Tile geometry of the fp32 kernels. BM rows per tile (of Q and of K
// alike); one warp per 16-row strip. Leading dimensions are padded against
// bank conflicts.
template <typename T, int D>
struct Cfg {
  static_assert(std::is_same<T, float>::value, "bf16 runs the sm90 kernels");
  static constexpr int BM = D == 128 ? 32 : 64;
  static constexpr int NW = BM / 16;
  static constexpr int NT = NW * 32;
  static constexpr int LDT = D + 4;   // [BM][D] input tiles
  static constexpr int LDF = D + 4;   // [BM][D] accumulators
  static constexpr int LDS = BM + 4;  // [BM][BM] scores
  static constexpr int LDP = BM + 4;  // [BM][BM] probabilities
  static constexpr int TILE = align128(BM * LDT * 4);
  static constexpr int ACC = align128(BM * LDF * 4);
  static constexpr int SCORE = align128(BM * LDS * 4);
  static constexpr int PROB = align128(BM * LDP * 4);
  static constexpr int ROW = align128(BM * 4);  // BM floats or int32 ids
  // Four row vectors each: two of fp32 row statistics, two of segment ids.
  static constexpr int FWD_SMEM = 3 * TILE + SCORE + PROB + ACC + 4 * ROW;
  // The backward kernels write P and dS over their warp's strip of the S
  // and dP tiles once read: dK/dV then fits two CTAs per SM.
  static constexpr int DQ_SMEM = 4 * TILE + 2 * SCORE + ACC + 4 * ROW;
  static constexpr int DKV_SMEM = 4 * TILE + 2 * SCORE + 2 * ACC + 4 * ROW;
};

// C[16][N] = A[16][K] . B[N][K]^T for this warp's strip, by FMA.
template <typename T, int N, int K>
__device__ __forceinline__ void warp_gemm_nt(const T* A, int lda, const T* B, int ldb,
                                             float* C, int ldc) {
  const int lane = threadIdx.x & 31;
  for (int idx = lane; idx < 16 * N; idx += 32) {
    const int i = idx / N, n = idx % N;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc = fmaf(A[i * lda + k], B[n * ldb + k], acc);
    C[i * ldc + n] = acc;
  }
  __syncwarp();
}

// C[16][N] += A[16][K] . B[K][N] for this warp's strip, by FMA.
template <typename T, int N, int K>
__device__ __forceinline__ void warp_gemm_nn(const T* A, int lda, const T* B, int ldb,
                                             float* C, int ldc) {
  const int lane = threadIdx.x & 31;
  for (int idx = lane; idx < 16 * N; idx += 32) {
    const int i = idx / N, n = idx % N;
    float acc = C[i * ldc + n];
    for (int k = 0; k < K; ++k) acc = fmaf(A[i * lda + k], B[k * ldb + n], acc);
    C[i * ldc + n] = acc;
  }
  __syncwarp();
}

// Rows [row0, row0 + BM) of one (b, h) slice into a [BM][ld] shared tile,
// 16 bytes per thread per step; rows at or past `rows` are zero-filled.
template <typename T, int D, int BM, int NT>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* base, long long st,
                                          int row0, int rows) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CPR = D / VEC;
  for (int c = threadIdx.x; c < BM * CPR; c += NT) {
    const int r = c / CPR, col = (c % CPR) * VEC;
    const int t = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < rows) val = *reinterpret_cast<const uint4*>(base + (long long)t * st + col);
    *reinterpret_cast<uint4*>(dst + r * ld + col) = val;
  }
}

// Segment ids of rows [row0, row0 + BM) of batch entry b (a [B, rows]
// int32 array) into shared memory.
template <int BM, int NT>
__device__ __forceinline__ void load_ids(int* dst, const int* ids, int b, int row0, int rows) {
  for (int i = threadIdx.x; i < BM; i += NT) {
    const int t = row0 + i;
    dst[i] = t < rows ? ids[(long long)b * rows + t] : 0;
  }
}

__device__ __forceinline__ bool visible_pair(int qpos, int kpos, int causal, int window) {
  if (!causal) return true;
  return qpos >= kpos && (window <= 0 || qpos - kpos < window);
}

// Tile culling, the Pallas kernels' predicate: with causal masking a K tile
// wholly in the Q tile's future, or (with a window) wholly before the
// window of its first row, holds no visible pair.
__device__ __forceinline__ bool visible_tile(int q_base, int k_base, int bm, int causal,
                                             int window) {
  if (!causal) return true;
  if (q_base + bm - 1 < k_base) return false;
  if (window > 0 && k_base + bm - 1 < q_base - (window - 1)) return false;
  return true;
}

// ---- bf16 kernels: TMA-fed tile rings and wgmma --------------------------------

constexpr int WG = 128;  // threads of a warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Tile geometry of the bf16 kernels at head dim D: two consumer
// warpgroups of 64 rows each and one producer warpgroup.
template <int D>
struct Sm90Cfg {
  static constexpr int CW = 2;              // consumer warpgroups
  static constexpr int NT = (CW + 1) * WG;  // threads per CTA
  static constexpr int STAGES = 2;          // depth of the streamed-tile ring
  static constexpr int ROW_BYTES = D * 2;   // one bf16 row
  // Forward: FBM query rows per CTA, FBN keys per streamed tile.
  static constexpr int FBM = 64 * CW;
  static constexpr int FBN = 128;
  static constexpr int FWD_Q = FBM * ROW_BYTES;
  static constexpr int FWD_KV = FBN * ROW_BYTES;
  static constexpr int FWD_SMEM = FWD_Q + 2 * STAGES * FWD_KV + STAGES * FBN * 4 + 1024 + 1024;
  // dQ: QBM query rows per CTA, QBN keys per streamed tile. Consumers hold
  // dQ (D / 2 floats), S and dP (QBN / 2 each) and the dS fragments
  // (QBN / 4 words): 128-key tiles at D=128 would need ~224 and spill.
  static constexpr int QBM = 64 * CW;
  static constexpr int QBN = D == 64 ? 128 : 64;
  static constexpr int DQ_Q = QBM * ROW_BYTES;
  static constexpr int DQ_KV = QBN * ROW_BYTES;
  static constexpr int DQ_SMEM = 2 * DQ_Q + 2 * STAGES * DQ_KV + STAGES * QBN * 4 + 1024 + 1024;
  // dK/dV: BBN keys per CTA, BBQ queries per streamed tile.
  static constexpr int BBN = 64 * CW;
  static constexpr int BBQ = 64;
  static constexpr int DKV_KV = BBN * ROW_BYTES;
  static constexpr int DKV_Q = BBQ * ROW_BYTES;
  static constexpr int DKV_SMEM =
      2 * DKV_KV + 2 * STAGES * DKV_Q + 3 * STAGES * BBQ * 4 + 1024 + 1024;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}
__device__ __forceinline__ int ceil_div(int a, int b) { return -floor_div(-a, b); }

// The K tiles [lo, hi) of `bk` keys (first at global position k_off) that
// the query rows [q_base, q_base + bq) can see: the Pallas culling
// predicate (causal, window) as an index range.
__device__ __forceinline__ void key_tiles(int q_base, int bq, int k_off, int bk, int nkt,
                                          int causal, int window, int& lo, int& hi) {
  lo = 0;
  hi = nkt;
  if (!causal) return;
  hi = min(nkt, floor_div(q_base + bq - 1 - k_off, bk) + 1);
  if (window > 0) lo = max(0, ceil_div(q_base - (window - 1) - (bk - 1) - k_off, bk));
  hi = max(hi, lo);
}

// The Q tiles [lo, hi) of `bq` rows (first at global position q_off) that
// can see the keys [k_base, k_base + bk).
__device__ __forceinline__ void query_tiles(int k_base, int bk, int q_off, int bq, int nqt,
                                            int causal, int window, int& lo, int& hi) {
  lo = 0;
  hi = nqt;
  if (!causal) return;
  lo = max(0, ceil_div(k_base - q_off - (bq - 1), bq));
  if (window > 0) hi = min(nqt, floor_div(k_base + bk + window - 2 - q_off, bq) + 1);
  hi = max(hi, lo);
}

// Whether every query of [q0, q0 + nq) sees every key of [k0, k0 + nk)
// under the causal/window mask.
__device__ __forceinline__ bool all_visible(int q0, int nq, int k0, int nk, int causal,
                                            int window) {
  if (!causal) return true;
  return q0 >= k0 + nk - 1 && (window <= 0 || q0 + nq - 1 - k0 < window);
}

// A [rows][D] bf16 tile at (row0, h, b) into shared memory as D / 64
// swizzled [rows][64] tiles, one TMA box each.
template <int D>
__device__ __forceinline__ void tma_tile(bf16* dst, int rows, const CUtensorMap* map,
                                         uint64_t* bar, int h, int row0, int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    hopper::tma_load_4d(dst + c * rows * 64, map, bar, 64 * c, h, row0, b);
}

// Descriptor of the K-major operand rows [row0, row0 + 64) of a [rows][D]
// tile at k step k (16 columns).
__device__ __forceinline__ uint64_t kmajor(const bf16* tile, int rows, int row0, int k) {
  return hopper::desc_sw128(tile + (k / 4) * rows * 64 + row0 * 64 + (k % 4) * 16, 16, 1024);
}

// Descriptor of the MN-major operand rows [16 k, 16 k + 16) of a [rows][D]
// tile (the rows are the reduction dim, D the N dim).
__device__ __forceinline__ uint64_t mnmajor(const bf16* tile, int rows, int k) {
  return hopper::desc_sw128(tile + k * 16 * 64, rows * 128, 1024);
}

// The register A operand of k step kk from an accumulator-layout array.
template <int N>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&x)[N], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = hopper::pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Two adjacent output values through a row pointer, in bf16 or fp32.
__device__ __forceinline__ void store2(void* row, int col, float x, float y, bool f32) {
  if (f32)
    *reinterpret_cast<float2*>(static_cast<float*>(row) + col) = make_float2(x, y);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(row) + col) =
        __floats2bfloat162_rn(x, y);
}

// A thread's two rows (t0 and t0 + 8) of a 64 x D accumulator in the
// wgmma layout into a [B, T, H, D] output with strides `so`, in bf16 or
// fp32; rows at or past T are not stored.
template <int D>
__device__ __forceinline__ void store_acc(void* out, Strides so, int b, int h, int t0, int T,
                                          const float (&acc)[D / 2], bool f32, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + 8 * r;
    if (t >= T) continue;
    unsigned char* row = static_cast<unsigned char*>(out) +
                         (b * so.b + (long long)t * so.t + h * so.h) * (f32 ? 4 : 2);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(row, 8 * j + 2 * (lane % 4), acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1], f32);
  }
}

// The producer warp's K/V stream: key tiles [lo, hi) of BN keys (and,
// with SEG, their ids) through the ST stages of sK/sV/sKid, each stage
// handed to the consumers on full[s] and taken back on empty[s].
template <int D, int BN, int ST, bool SEG>
__device__ __forceinline__ void stream_kv(bf16* sK, bf16* sV, int* sKid, uint64_t* full,
                                          uint64_t* empty, const CUtensorMap* mk,
                                          const CUtensorMap* mv, const int* k_ids, int b,
                                          int h, int Tk, int lo, int hi, int lane) {
  for (int i = 0; i < hi - lo; ++i) {
    const int s = i % ST, k0 = (lo + i) * BN;
    if (i >= ST) hopper::mbar_wait(&empty[s], (i / ST - 1) & 1);
    if (SEG)
      for (int c = lane; c < BN; c += 32)
        sKid[s * BN + c] = k0 + c < Tk ? k_ids[(long long)b * Tk + k0 + c] : 0;
    if (lane == 0) {
      hopper::mbar_expect_tx(&full[s], 2 * BN * D * 2);
      tma_tile<D>(sK + s * BN * D, BN, mk, &full[s], h, k0, b);
      tma_tile<D>(sV + s * BN * D, BN, mv, &full[s], h, k0, b);
    } else {
      hopper::mbar_arrive(&full[s]);
    }
  }
}

// bf16 forward. One CTA owns FBM query rows of one (b, h); the producer
// warp loads Q once and streams K/V tiles (and, with SEG, their ids)
// through the ring; each consumer warpgroup runs the online softmax for
// its 64 rows with S and O in registers. Modes as in flash_fwd_kernel.
template <int D, bool SEG>
__global__ void __launch_bounds__(Sm90Cfg<D>::NT, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, void* __restrict__ o,
                   float* __restrict__ lse, float* __restrict__ m_out, float* __restrict__ l_out,
                   const int* __restrict__ q_ids, const int* __restrict__ k_ids, Strides so,
                   int H, int Tq, int Tk, int causal, int q_off, int k_off, int window,
                   float scale) {
  using C = Sm90Cfg<D>;
  constexpr int BM = C::FBM, BN = C::FBN, ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + C::FWD_Q);
  bf16* sV = reinterpret_cast<bf16*>(smem + C::FWD_Q + ST * C::FWD_KV);
  int* sKid = reinterpret_cast<int*>(smem + C::FWD_Q + 2 * ST * C::FWD_KV);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKid + ST * BN);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int nqt = (Tq + BM - 1) / BM;
  const int qt = causal ? nqt - 1 - blockIdx.x : blockIdx.x;  // longest rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row0 = qt * BM, q_base = q_off + row0;
  int lo, hi;
  key_tiles(q_base, BM, k_off, BN, (Tk + BN - 1) / BN, causal, window, lo, hi);
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], C::CW * WG);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == C::CW) {
    // Producer: its first warp issues every load; the rest only give up
    // their registers.
    hopper::regs_dec<40>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x / 32 != C::CW * 4 || hi == lo) return;
    if (lane == 0) {
      hopper::prefetch_map(&mq);
      hopper::prefetch_map(&mk);
      hopper::prefetch_map(&mv);
      hopper::mbar_expect_tx(q_full, C::FWD_Q);
      tma_tile<D>(sQ, BM, &mq, q_full, h, row0, b);
    }
    stream_kv<D, BN, ST, SEG>(sK, sV, sKid, full, empty, &mk, &mv, k_ids, b, h, Tk, lo, hi, lane);
    return;
  }

  // Consumer warpgroup wg: query rows [64 wg, 64 wg + 64) of the tile.
  hopper::regs_inc<232>();
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  const int wrow0 = 64 * wg;
  const float c2 = scale * LOG2E;
  int qpos[2], qid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tq = row0 + wrow0 + 16 * warp + lane / 4 + 8 * r;
    qpos[r] = q_off + tq;
    qid[r] = SEG && tq < Tq ? q_ids[(long long)b * Tq + tq] : 0;
  }
  float acc[D / 2], sc[BN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.0f;
  float m2[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.0f, 0.0f};  // m2: log2 units

  if (hi > lo) hopper::mbar_wait(q_full, 0);
  for (int i = 0; i < hi - lo; ++i) {
    const int s = i % ST, k0 = (lo + i) * BN;
    const bf16* tK = sK + s * BN * D;
    const bf16* tV = sV + s * BN * D;
    hopper::mbar_wait(&full[s], (i / ST) & 1);

    // S = Q . K^T for this warpgroup's 64 rows.
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      hopper::wgmma_ss<BN>(sc, kmajor(sQ, BM, wrow0, k), kmajor(tK, BN, 0, k), k > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    if (SEG || k0 + BN > Tk ||
        !all_visible(q_base + wrow0, 64, k_off + k0, BN, causal, window)) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * (lane % 4) + (e & 1), r = e >> 1;
          const bool ok = k0 + c < Tk && visible_pair(qpos[r], k_off + k0 + c, causal, window) &&
                          (!SEG || sKid[s * BN + c] == qid[r]);
          if (!ok) sc[4 * j + e] = -INFINITY;
        }
    }

    // Online softmax in the log2 domain; each row lives on four lanes.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    float m_use[2], corr[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m2[r], quad_max(mx[r]) * c2);
      m_use[r] = m_new == -INFINITY ? 0.0f : m_new;  // a row with no key yet
      corr[r] = exp2f(m2[r] - m_use[r]);
      m2[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(sc[4 * j + e], c2, -m_use[e >> 1]));
        sc[4 * j + e] = p;
        psum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) lsum[r] = lsum[r] * corr[r] + psum[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];

    // O += P . V, P rounded to bf16 (V's dtype, as the Pallas kernel).
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) a_frag(pa[kk], sc, kk);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) hopper::wgmma_rs<D>(acc, pa[kk], mnmajor(tV, BN, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(lsum[r]);
    const int tq = row0 + wrow0 + 16 * warp + lane / 4 + 8 * r;
    if (tq >= Tq) continue;
    void* row = reinterpret_cast<unsigned char*>(o) +
                (b * so.b + (long long)tq * so.t + h * so.h) * (m_out ? 4 : 2);
    const float inv = m_out ? 1.0f : 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(row, 8 * j + 2 * (lane % 4), acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv,
             m_out != nullptr);
    if (lane % 4 != 0) continue;
    const long long at = (long long)bh * Tq + tq;
    if (m_out != nullptr) {
      m_out[at] = m2[r] == -INFINITY ? NEG_INF : m2[r] * LN2;
      l_out[at] = l;
    } else if (lse != nullptr) {
      lse[at] = l > 0.0f ? (m2[r] + log2f(l)) * LN2 : -NEG_INF;
    }
  }
}

// bf16 dQ. One CTA owns QBM query rows of one (b, h): the producer warp
// loads Q and dO once, then streams K/V tiles (and, with SEG, their ids)
// through the ring over the key tiles these rows can see; each consumer
// warpgroup keeps dQ of its 64 rows in registers over the whole key loop.
// A CTA that sees no key tile (a future block of the ring) loads nothing
// and writes dQ = 0.
template <int D, bool SEG>
__global__ void __launch_bounds__(Sm90Cfg<D>::NT, 1)
    flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      const __grid_constant__ CUtensorMap mdo, const float* __restrict__ lse,
                      const float* __restrict__ delta, void* __restrict__ dq,
                      const int* __restrict__ q_ids, const int* __restrict__ k_ids, Strides sdq,
                      int out_f32, int H, int Tq, int Tk, int causal, int q_off, int k_off,
                      int window, float scale) {
  using C = Sm90Cfg<D>;
  constexpr int BM = C::QBM, BN = C::QBN, ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = reinterpret_cast<bf16*>(smem + C::DQ_Q);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * C::DQ_Q);
  bf16* sV = reinterpret_cast<bf16*>(smem + 2 * C::DQ_Q + ST * C::DQ_KV);
  int* sKid = reinterpret_cast<int*>(smem + 2 * C::DQ_Q + 2 * ST * C::DQ_KV);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKid + ST * BN);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;

  const int nqt = (Tq + BM - 1) / BM;
  const int qt = causal ? nqt - 1 - blockIdx.x : blockIdx.x;  // longest rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row0 = qt * BM, q_base = q_off + row0;
  int lo, hi;
  key_tiles(q_base, BM, k_off, BN, (Tk + BN - 1) / BN, causal, window, lo, hi);
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], C::CW * WG);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == C::CW) {
    hopper::regs_dec<40>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x / 32 != C::CW * 4 || hi == lo) return;
    if (lane == 0) {
      hopper::prefetch_map(&mk);
      hopper::prefetch_map(&mv);
      hopper::mbar_expect_tx(q_full, 2 * C::DQ_Q);
      tma_tile<D>(sQ, BM, &mq, q_full, h, row0, b);
      tma_tile<D>(sDO, BM, &mdo, q_full, h, row0, b);
    }
    stream_kv<D, BN, ST, SEG>(sK, sV, sKid, full, empty, &mk, &mv, k_ids, b, h, Tk, lo, hi, lane);
    return;
  }

  // Consumer warpgroup wg: query rows [64 wg, 64 wg + 64) of the tile.
  hopper::regs_inc<232>();
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  const int wrow0 = 64 * wg;
  const float c2 = scale * LOG2E;
  int qpos[2], qid[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tq = row0 + wrow0 + 16 * warp + lane / 4 + 8 * r;
    const bool in = tq < Tq;
    qpos[r] = q_off + tq;
    qid[r] = SEG && in ? q_ids[(long long)b * Tq + tq] : 0;
    // A padded row gets lse = +1e30, so exp2(s - lse) is exactly zero.
    lse2[r] = in ? lse[(long long)bh * Tq + tq] * LOG2E : -NEG_INF;
    dlt[r] = in ? delta[(long long)bh * Tq + tq] : 0.0f;
  }
  float dq_acc[D / 2], sc[BN / 2], dps[BN / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = dps[i] = 0.0f;

  if (hi > lo) hopper::mbar_wait(q_full, 0);
  for (int i = 0; i < hi - lo; ++i) {
    const int s = i % ST, k0 = (lo + i) * BN;
    const bf16* tK = sK + s * BN * D;
    const bf16* tV = sV + s * BN * D;
    hopper::mbar_wait(&full[s], (i / ST) & 1);

    // S = Q . K^T and dP = dO . V^T, two groups in flight.
    hopper::fence_regs(sc);
    hopper::fence_regs(dps);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      hopper::wgmma_ss<BN>(sc, kmajor(sQ, BM, wrow0, k), kmajor(tK, BN, 0, k), k > 0);
    hopper::wgmma_commit();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      hopper::wgmma_ss<BN>(dps, kmajor(sDO, BM, wrow0, k), kmajor(tV, BN, 0, k), k > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sc);

    // P = exp2(S c - lse2) under the masks. Keys past Tk read as zeros
    // (S = 0, P = exp2(-lse2) != 0), so a ragged last tile takes the mask.
    const bool masked = SEG || k0 + BN > Tk ||
                        !all_visible(q_base + wrow0, 64, k_off + k0, BN, causal, window);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * (lane % 4) + (e & 1), r = e >> 1;
        float p = exp2f(fmaf(sc[4 * j + e], c2, -lse2[r]));
        if (masked && !(k0 + c < Tk && visible_pair(qpos[r], k_off + k0 + c, causal, window) &&
                        (!SEG || sKid[s * BN + c] == qid[r])))
          p = 0.0f;
        sc[4 * j + e] = p;
      }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dps);
    // dS = P (dP - delta) scale, from the fp32 P.
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dps[4 * j + e] = sc[4 * j + e] * (dps[4 * j + e] - dlt[e >> 1]) * scale;

    // dQ += dS . K, dS rounded to bf16 (K's dtype, as the Pallas kernel),
    // the K tile read MN-major.
    uint32_t da[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) a_frag(da[kk], dps, kk);
    hopper::fence_regs(dq_acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) hopper::wgmma_rs<D>(dq_acc, da[kk], mnmajor(tK, BN, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq_acc);
    hopper::mbar_arrive(&empty[s]);
  }

  store_acc<D>(dq, sdq, b, h, row0 + wrow0 + 16 * warp + lane / 4, Tq, dq_acc, out_f32, lane);
}

// bf16 dK/dV. One CTA owns BBN keys of one (b, h): the producer warp loads
// K and V once, then streams Q and dO tiles with their rows' lse (in log2
// units), delta and (SEG) ids through the ring, from the first query tile
// that can see these keys; each consumer warpgroup keeps dK and dV of its
// 64 keys in registers over the whole query loop.
template <int D, bool SEG>
__global__ void __launch_bounds__(Sm90Cfg<D>::NT, 1)
    flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap mdo, const float* __restrict__ lse,
                       const float* __restrict__ delta, void* __restrict__ dk,
                       void* __restrict__ dv, const int* __restrict__ q_ids,
                       const int* __restrict__ k_ids, Strides sdk, Strides sdv, int out_f32,
                       int H, int Tq, int Tk, int causal, int q_off, int k_off, int window,
                       float scale) {
  using C = Sm90Cfg<D>;
  constexpr int BN = C::BBN, BQ = C::BBQ, ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + C::DKV_KV);
  bf16* sQ = reinterpret_cast<bf16*>(smem + 2 * C::DKV_KV);
  bf16* sDO = reinterpret_cast<bf16*>(smem + 2 * C::DKV_KV + ST * C::DKV_Q);
  float* sLse = reinterpret_cast<float*>(smem + 2 * C::DKV_KV + 2 * ST * C::DKV_Q);
  float* sDelta = sLse + ST * BQ;
  int* sQid = reinterpret_cast<int*>(sDelta + ST * BQ);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sQid + ST * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int key0 = blockIdx.x * BN, k_base = k_off + key0;
  int lo, hi;
  query_tiles(k_base, BN, q_off, BQ, (Tq + BQ - 1) / BQ, causal, window, lo, hi);
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 32);
      hopper::mbar_init(&empty[s], C::CW * WG);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == C::CW) {
    hopper::regs_dec<40>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x / 32 != C::CW * 4 || hi == lo) return;
    if (lane == 0) {
      hopper::prefetch_map(&mq);
      hopper::prefetch_map(&mdo);
      hopper::mbar_expect_tx(kv_full, 2 * C::DKV_KV);
      tma_tile<D>(sK, BN, &mk, kv_full, h, key0, b);
      tma_tile<D>(sV, BN, &mv, kv_full, h, key0, b);
    }
    for (int i = 0; i < hi - lo; ++i) {
      const int s = i % ST, q0 = (lo + i) * BQ;
      if (i >= ST) hopper::mbar_wait(&empty[s], (i / ST - 1) & 1);
      for (int c = lane; c < BQ; c += 32) {
        const int tq = q0 + c;
        const bool in = tq < Tq;
        // A padded row gets lse = +1e30, so exp2(s - lse) is exactly zero.
        sLse[s * BQ + c] = in ? lse[(long long)bh * Tq + tq] * LOG2E : -NEG_INF;
        sDelta[s * BQ + c] = in ? delta[(long long)bh * Tq + tq] : 0.0f;
        if (SEG) sQid[s * BQ + c] = in ? q_ids[(long long)b * Tq + tq] : 0;
      }
      if (lane == 0) {
        hopper::mbar_expect_tx(&full[s], 2 * C::DKV_Q);
        tma_tile<D>(sQ + s * BQ * D, BQ, &mq, &full[s], h, q0, b);
        tma_tile<D>(sDO + s * BQ * D, BQ, &mdo, &full[s], h, q0, b);
      } else {
        hopper::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // Consumer warpgroup wg: keys [64 wg, 64 wg + 64) of the CTA's tile.
  hopper::regs_inc<232>();
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  const int krow0 = 64 * wg;
  const float c2 = scale * LOG2E;
  int kpos[2], kid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tk = key0 + krow0 + 16 * warp + lane / 4 + 8 * r;
    kpos[r] = k_off + tk;
    kid[r] = SEG && tk < Tk ? k_ids[(long long)b * Tk + tk] : 0;
  }
  float dk_acc[D / 2], dv_acc[D / 2], st[BQ / 2], dpt[BQ / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.0f;

  if (hi > lo) hopper::mbar_wait(kv_full, 0);
  for (int i = 0; i < hi - lo; ++i) {
    const int s = i % ST, q0 = (lo + i) * BQ;
    const bf16* tQ = sQ + s * BQ * D;
    const bf16* tDO = sDO + s * BQ * D;
    const float* rLse = sLse + s * BQ;
    const float* rDelta = sDelta + s * BQ;
    hopper::mbar_wait(&full[s], (i / ST) & 1);

    // S^T = K . Q^T and dP^T = V . dO^T, two groups in flight.
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);
    hopper::wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      hopper::wgmma_ss<BQ>(st, kmajor(sK, BN, krow0, k), kmajor(tQ, BQ, 0, k), k > 0);
    hopper::wgmma_commit();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      hopper::wgmma_ss<BQ>(dpt, kmajor(sV, BN, krow0, k), kmajor(tDO, BQ, 0, k), k > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(st);

    // P^T = exp2(S^T c - lse2) under the masks.
    const bool masked = SEG || q0 + BQ > Tq ||
                        !all_visible(q_off + q0, BQ, k_base + krow0, 64, causal, window);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * (lane % 4) + (e & 1), r = e >> 1;
        float p = exp2f(fmaf(st[4 * j + e], c2, -rLse[c]));
        if (masked && !(q0 + c < Tq && visible_pair(q_off + q0 + c, kpos[r], causal, window) &&
                        (!SEG || sQid[s * BQ + c] == kid[r])))
          p = 0.0f;
        st[4 * j + e] = p;
      }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dpt);
    // dS^T = P^T (dP^T - delta) scale, from the fp32 P.
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * (lane % 4) + (e & 1);
        dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - rDelta[c]) * scale;
      }

    // dV += P^T . dO and dK += dS^T . Q, P and dS rounded to bf16.
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      a_frag(pa[kk], st, kk);
      a_frag(da[kk], dpt, kk);
    }
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      hopper::wgmma_rs<D>(dv_acc, pa[kk], mnmajor(tDO, BQ, kk));
      hopper::wgmma_rs<D>(dk_acc, da[kk], mnmajor(tQ, BQ, kk));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::mbar_arrive(&empty[s]);
  }

  const int tk = key0 + krow0 + 16 * warp + lane / 4;
  store_acc<D>(dk, sdk, b, h, tk, Tk, dk_acc, out_f32, lane);
  store_acc<D>(dv, sdv, b, h, tk, Tk, dv_acc, out_f32, lane);
}

// fp32 forward. Plain mode (lse == m_out == nullptr): o = normalized O in T.
// Train mode (lse set): also lse, +1e30 on rows with no visible key.
// State mode (m_out and l_out set): o is fp32 and receives the
// unnormalized accumulator; m and l are written, no lse.
template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(Cfg<T, D>::NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, void* __restrict__ o, float* __restrict__ lse,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     const int* __restrict__ q_ids, const int* __restrict__ k_ids, Strides sq,
                     Strides sk, Strides sv, Strides so, int H, int Tq, int Tk, int causal,
                     int q_off, int k_off, int window, float scale) {
  static_assert(std::is_same<T, float>::value, "bf16 runs flash_fwd_sm90");
  using C = Cfg<T, D>;
  constexpr int BM = C::BM;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = reinterpret_cast<T*>(smem + C::TILE);
  T* sV = reinterpret_cast<T*>(smem + 2 * C::TILE);
  float* sS = reinterpret_cast<float*>(smem + 3 * C::TILE);
  T* sP = reinterpret_cast<T*>(smem + 3 * C::TILE + C::SCORE);
  float* sAcc = reinterpret_cast<float*>(smem + 3 * C::TILE + C::SCORE + C::PROB);
  float* sM = reinterpret_cast<float*>(smem + 3 * C::TILE + C::SCORE + C::PROB + C::ACC);
  float* sL = sM + C::ROW / 4;
  int* sQid = reinterpret_cast<int*>(sL + C::ROW / 4);
  int* sKid = sQid + C::ROW / 4;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;

  load_tile<T, D, BM, C::NT>(sQ, C::LDT, q + b * sq.b + h * sq.h, sq.t, row0, Tq);
  if (SEG) load_ids<BM, C::NT>(sQid, q_ids, b, row0, Tq);
  for (int i = threadIdx.x; i < BM * C::LDF; i += C::NT) sAcc[i] = 0.0f;
  for (int i = threadIdx.x; i < BM; i += C::NT) {
    sM[i] = NEG_INF;
    sL[i] = 0.0f;
  }
  __syncthreads();

  const int q_base = q_off + row0;
  const int nkt = (Tk + BM - 1) / BM;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k_base = k_off + kt * BM;
    if (!visible_tile(q_base, k_base, BM, causal, window)) continue;
    load_tile<T, D, BM, C::NT>(sK, C::LDT, k + b * sk.b + h * sk.h, sk.t, kt * BM, Tk);
    load_tile<T, D, BM, C::NT>(sV, C::LDT, v + b * sv.b + h * sv.h, sv.t, kt * BM, Tk);
    if (SEG) load_ids<BM, C::NT>(sKid, k_ids, b, kt * BM, Tk);
    __syncthreads();

    warp_gemm_nt<T, BM, D>(sQ + r0 * C::LDT, C::LDT, sK, C::LDT, sS + r0 * C::LDS, C::LDS);
    {
      // Online softmax over the strip's 16 rows at once: two lanes per
      // row, each taking every other column, combined by one shuffle.
      const int r = r0 + (lane >> 1), half = lane & 1;
      const int qpos = q_base + r;
      const int qid = SEG ? sQid[r] : 0;
      constexpr int PER = BM / 2;
      float s[PER];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int c = 2 * j + half;
        const bool ok = (kt * BM + c < Tk) && visible_pair(qpos, k_base + c, causal, window) &&
                        (!SEG || sKid[c] == qid);
        s[j] = ok ? sS[r * C::LDS + c] * scale : NEG_INF;
        mx = fmaxf(mx, s[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float corr = m_new > NEG_INF / 2 ? expf(m_prev - m_new) : 1.0f;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const float p = s[j] <= NEG_INF / 2 ? 0.0f : expf(s[j] - m_new);
        sum += p;
        sP[r * C::LDP + 2 * j + half] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      for (int d = half; d < D; d += 2) sAcc[r * C::LDF + d] *= corr;
      __syncwarp();
      if (half == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * corr + sum;
      }
    }
    __syncwarp();
    warp_gemm_nn<T, D, BM>(sP + r0 * C::LDP, C::LDP, sV, C::LDT, sAcc + r0 * C::LDF, C::LDF);
    __syncthreads();
  }

  for (int i = 0; i < 16; ++i) {
    const int r = r0 + i;
    const int t = row0 + r;
    if (t >= Tq) break;
    const float l = sL[r];
    const long long off = b * so.b + (long long)t * so.t + h * so.h;
    if (m_out != nullptr) {
      float* arow = static_cast<float*>(o) + off;
      for (int d = lane; d < D; d += 32) arow[d] = sAcc[r * C::LDF + d];
      if (lane == 0) {
        m_out[(long long)bh * Tq + t] = sM[r];
        l_out[(long long)bh * Tq + t] = l;
      }
      continue;
    }
    T* orow = static_cast<T*>(o) + off;
    for (int d = lane; d < D; d += 32) orow[d] = sAcc[r * C::LDF + d] / fmaxf(l, 1e-30f);
    if (lse != nullptr && lane == 0)
      lse[(long long)bh * Tq + t] = l > 0.0f ? sM[r] + logf(fmaxf(l, 1e-30f)) : -NEG_INF;
  }
}

// fp32 dQ (bf16 runs flash_bwd_dq_sm90).
template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(Cfg<T, D>::NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, const int* __restrict__ q_ids,
                        const int* __restrict__ k_ids, Strides sq, Strides sk, Strides sv,
                        Strides sdo, Strides sdq, int H, int Tq, int Tk, int causal, int q_off,
                        int k_off, int window, float scale) {
  static_assert(std::is_same<T, float>::value, "bf16 runs flash_bwd_dq_sm90");
  using C = Cfg<T, D>;
  constexpr int BM = C::BM;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = reinterpret_cast<T*>(smem + C::TILE);
  T* sK = reinterpret_cast<T*>(smem + 2 * C::TILE);
  T* sV = reinterpret_cast<T*>(smem + 3 * C::TILE);
  float* sS = reinterpret_cast<float*>(smem + 4 * C::TILE);
  float* sDP = reinterpret_cast<float*>(smem + 4 * C::TILE + C::SCORE);
  float* sAcc = reinterpret_cast<float*>(smem + 4 * C::TILE + 2 * C::SCORE);
  float* sLse = reinterpret_cast<float*>(smem + 4 * C::TILE + 2 * C::SCORE + C::ACC);
  float* sDelta = sLse + C::ROW / 4;
  int* sQid = reinterpret_cast<int*>(sDelta + C::ROW / 4);
  int* sKid = sQid + C::ROW / 4;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  T* sDS = reinterpret_cast<T*>(sS + r0 * C::LDS);  // this strip's dS, [16][LDP]

  load_tile<T, D, BM, C::NT>(sQ, C::LDT, q + b * sq.b + h * sq.h, sq.t, row0, Tq);
  load_tile<T, D, BM, C::NT>(sDO, C::LDT, dout + b * sdo.b + h * sdo.h, sdo.t, row0, Tq);
  if (SEG) load_ids<BM, C::NT>(sQid, q_ids, b, row0, Tq);
  for (int i = threadIdx.x; i < BM * C::LDF; i += C::NT) sAcc[i] = 0.0f;
  for (int i = threadIdx.x; i < BM; i += C::NT) {
    const int t = row0 + i;
    // A padded row gets lse = +1e30, so exp(s - lse) is exactly zero.
    sLse[i] = t < Tq ? lse[(long long)bh * Tq + t] : -NEG_INF;
    sDelta[i] = t < Tq ? delta[(long long)bh * Tq + t] : 0.0f;
  }
  __syncthreads();

  const int q_base = q_off + row0;
  const int nkt = (Tk + BM - 1) / BM;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k_base = k_off + kt * BM;
    if (!visible_tile(q_base, k_base, BM, causal, window)) continue;
    load_tile<T, D, BM, C::NT>(sK, C::LDT, k + b * sk.b + h * sk.h, sk.t, kt * BM, Tk);
    load_tile<T, D, BM, C::NT>(sV, C::LDT, v + b * sv.b + h * sv.h, sv.t, kt * BM, Tk);
    if (SEG) load_ids<BM, C::NT>(sKid, k_ids, b, kt * BM, Tk);
    __syncthreads();

    warp_gemm_nt<T, BM, D>(sQ + r0 * C::LDT, C::LDT, sK, C::LDT, sS + r0 * C::LDS, C::LDS);
    warp_gemm_nt<T, BM, D>(sDO + r0 * C::LDT, C::LDT, sV, C::LDT, sDP + r0 * C::LDS, C::LDS);
    float ds[16][BM / 32];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = r0 + i;
      const int qpos = q_base + r;
      const float lse_r = sLse[r], delta_r = sDelta[r];
      const int qid = SEG ? sQid[r] : 0;
#pragma unroll
      for (int j = 0; j < BM / 32; ++j) {
        const int c = lane + 32 * j;
        const bool ok = (kt * BM + c < Tk) && visible_pair(qpos, k_base + c, causal, window) &&
                        (!SEG || sKid[c] == qid);
        const float p = ok ? expf(sS[r * C::LDS + c] * scale - lse_r) : 0.0f;
        ds[i][j] = p * (sDP[r * C::LDS + c] - delta_r) * scale;
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int j = 0; j < BM / 32; ++j) sDS[i * C::LDP + lane + 32 * j] = ds[i][j];
    __syncwarp();
    warp_gemm_nn<T, D, BM>(sDS, C::LDP, sK, C::LDT, sAcc + r0 * C::LDF, C::LDF);
    __syncthreads();
  }

  for (int i = 0; i < 16; ++i) {
    const int r = r0 + i;
    const int t = row0 + r;
    if (t >= Tq) break;
    store_row<D>(dq + b * sdq.b + (long long)t * sdq.t + h * sdq.h, sAcc + r * C::LDF, lane);
  }
}

// fp32 dK/dV (bf16 runs flash_bwd_dkv_sm90).
template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(Cfg<T, D>::NT)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         const int* __restrict__ q_ids, const int* __restrict__ k_ids,
                         Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                         Strides sdv, int H, int Tq, int Tk, int causal, int q_off, int k_off,
                         int window, float scale) {
  static_assert(std::is_same<T, float>::value, "bf16 runs flash_bwd_dkv_sm90");
  using C = Cfg<T, D>;
  constexpr int BM = C::BM;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = reinterpret_cast<T*>(smem + C::TILE);
  T* sQ = reinterpret_cast<T*>(smem + 2 * C::TILE);
  T* sDO = reinterpret_cast<T*>(smem + 3 * C::TILE);
  float* sS = reinterpret_cast<float*>(smem + 4 * C::TILE);            // S^T  [k][q]
  float* sDP = reinterpret_cast<float*>(smem + 4 * C::TILE + C::SCORE);  // dP^T [k][q]
  float* sDK = reinterpret_cast<float*>(smem + 4 * C::TILE + 2 * C::SCORE);
  float* sDV = reinterpret_cast<float*>(smem + 4 * C::TILE + 2 * C::SCORE + C::ACC);
  float* sLse = reinterpret_cast<float*>(smem + 4 * C::TILE + 2 * C::SCORE + 2 * C::ACC);
  float* sDelta = sLse + C::ROW / 4;
  int* sQid = reinterpret_cast<int*>(sDelta + C::ROW / 4);
  int* sKid = sQid + C::ROW / 4;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row0 = blockIdx.x * BM;  // first key row of this CTA
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  T* sP = reinterpret_cast<T*>(sS + r0 * C::LDS);    // this strip's P^T,  [16][LDP]
  T* sDS = reinterpret_cast<T*>(sDP + r0 * C::LDS);  // this strip's dS^T, [16][LDP]

  load_tile<T, D, BM, C::NT>(sK, C::LDT, k + b * sk.b + h * sk.h, sk.t, row0, Tk);
  load_tile<T, D, BM, C::NT>(sV, C::LDT, v + b * sv.b + h * sv.h, sv.t, row0, Tk);
  if (SEG) load_ids<BM, C::NT>(sKid, k_ids, b, row0, Tk);
  for (int i = threadIdx.x; i < BM * C::LDF; i += C::NT) {
    sDK[i] = 0.0f;
    sDV[i] = 0.0f;
  }

  const int k_base = k_off + row0;
  const int nqt = (Tq + BM - 1) / BM;
  for (int qt = 0; qt < nqt; ++qt) {
    const int q_base = q_off + qt * BM;
    if (!visible_tile(q_base, k_base, BM, causal, window)) continue;
    __syncthreads();  // the previous tile's readers are done with sQ/sDO/rows
    load_tile<T, D, BM, C::NT>(sQ, C::LDT, q + b * sq.b + h * sq.h, sq.t, qt * BM, Tq);
    load_tile<T, D, BM, C::NT>(sDO, C::LDT, dout + b * sdo.b + h * sdo.h, sdo.t, qt * BM, Tq);
    if (SEG) load_ids<BM, C::NT>(sQid, q_ids, b, qt * BM, Tq);
    for (int i = threadIdx.x; i < BM; i += C::NT) {
      const int t = qt * BM + i;
      sLse[i] = t < Tq ? lse[(long long)bh * Tq + t] : -NEG_INF;
      sDelta[i] = t < Tq ? delta[(long long)bh * Tq + t] : 0.0f;
    }
    __syncthreads();

    warp_gemm_nt<T, BM, D>(sK + r0 * C::LDT, C::LDT, sQ, C::LDT, sS + r0 * C::LDS, C::LDS);
    warp_gemm_nt<T, BM, D>(sV + r0 * C::LDT, C::LDT, sDO, C::LDT, sDP + r0 * C::LDS, C::LDS);
    float p[16][BM / 32], ds[16][BM / 32];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = r0 + i;
      const int kpos = k_base + r;
      const int kid = SEG ? sKid[r] : 0;
#pragma unroll
      for (int j = 0; j < BM / 32; ++j) {
        const int c = lane + 32 * j;
        const bool ok = (qt * BM + c < Tq) && visible_pair(q_base + c, kpos, causal, window) &&
                        (!SEG || sQid[c] == kid);
        p[i][j] = ok ? expf(sS[r * C::LDS + c] * scale - sLse[c]) : 0.0f;
        ds[i][j] = p[i][j] * (sDP[r * C::LDS + c] - sDelta[c]) * scale;
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int j = 0; j < BM / 32; ++j) {
        sP[i * C::LDP + lane + 32 * j] = p[i][j];
        sDS[i * C::LDP + lane + 32 * j] = ds[i][j];
      }
    __syncwarp();
    warp_gemm_nn<T, D, BM>(sP, C::LDP, sDO, C::LDT, sDV + r0 * C::LDF, C::LDF);
    warp_gemm_nn<T, D, BM>(sDS, C::LDP, sQ, C::LDT, sDK + r0 * C::LDF, C::LDF);
  }
  __syncthreads();

  for (int i = 0; i < 16; ++i) {
    const int r = r0 + i;
    const int t = row0 + r;
    if (t >= Tk) break;
    store_row<D>(dk + b * sdk.b + (long long)t * sdk.t + h * sdk.h, sDK + r * C::LDF, lane);
    store_row<D>(dv + b * sdv.b + (long long)t * sdv.t + h * sdv.h, sDV + r * C::LDF, lane);
  }
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

constexpr int kUnsupported = -1;
constexpr int kTensorMapRefused = -2;

// Raise the dynamic shared-memory limit of one kernel instantiation, once
// per device.
template <auto Kernel>
int prepare(int smem) {
  constexpr int kMaxDevices = 64;
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  if (int err = (int)cudaGetDevice(&dev)) return err;
  if (dev < kMaxDevices && ready[dev]) return 0;
  const int err =
      (int)cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == 0 && dev < kMaxDevices) ready[dev] = true;
  return err;
}

// cuTensorMapEncodeTiled, from the driver the runtime has loaded (the
// library links no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a [B, T, H, D] bf16 tensor with element strides `s`,
// read in boxes of `rows` rows by 64 columns (the 128-byte swizzle's
// width), dims (D, H, T, B) innermost first: the q/k/v views of the
// model's fused [B, T, 3, H, D] tensor are read in place. Rows past T read
// as zeros.
int tensor_map(CUtensorMap* map, const void* base, int B, int T, int H, int D, Strides s,
               int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kTensorMapRefused;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.h * 2, (cuuint64_t)s.t * 2, (cuuint64_t)s.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapRefused;
}

template <int D>
int launch_fwd_sm90(int B, int H, int Tq, int Tk, const void* q, const void* k, const void* v,
                    void* o, void* lse, void* m, void* l, const void* q_ids, const void* k_ids,
                    const long long* s, int causal, int q_off, int k_off, int window,
                    float scale, cudaStream_t stream) {
  using C = Sm90Cfg<D>;
  constexpr auto seg = flash_fwd_sm90<D, true>;
  constexpr auto plain = flash_fwd_sm90<D, false>;
  if (int err = q_ids ? prepare<seg>(C::FWD_SMEM) : prepare<plain>(C::FWD_SMEM)) return err;
  CUtensorMap mq, mk, mv;
  if (int err = tensor_map(&mq, q, B, Tq, H, D, strides_at(s, 0), C::FBM)) return err;
  if (int err = tensor_map(&mk, k, B, Tk, H, D, strides_at(s, 1), C::FBN)) return err;
  if (int err = tensor_map(&mv, v, B, Tk, H, D, strides_at(s, 2), C::FBN)) return err;
  dim3 grid((Tq + C::FBM - 1) / C::FBM, B * H);
  (q_ids ? seg : plain)<<<grid, C::NT, C::FWD_SMEM, stream>>>(
      mq, mk, mv, o, (float*)lse, (float*)m, (float*)l, (const int*)q_ids, (const int*)k_ids,
      strides_at(s, 3), H, Tq, Tk, causal, q_off, k_off, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_fwd(int B, int H, int Tq, int Tk, const void* q, const void* k, const void* v,
               void* o, void* lse, void* m, void* l, const void* q_ids, const void* k_ids,
               const long long* s, int causal, int q_off, int k_off, int window, float scale,
               cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_fwd_sm90<D>(B, H, Tq, Tk, q, k, v, o, lse, m, l, q_ids, k_ids, s, causal,
                              q_off, k_off, window, scale, stream);
  } else {
    using C = Cfg<T, D>;
    constexpr auto seg = flash_fwd_kernel<T, D, true>;
    constexpr auto plain = flash_fwd_kernel<T, D, false>;
    if (int err = q_ids ? prepare<seg>(C::FWD_SMEM) : prepare<plain>(C::FWD_SMEM)) return err;
    dim3 grid((Tq + C::BM - 1) / C::BM, B * H);
    (q_ids ? seg : plain)<<<grid, C::NT, C::FWD_SMEM, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, o, (float*)lse, (float*)m, (float*)l,
        (const int*)q_ids, (const int*)k_ids, strides_at(s, 0), strides_at(s, 1),
        strides_at(s, 2), strides_at(s, 3), H, Tq, Tk, causal, q_off, k_off, window, scale);
    return (int)cudaGetLastError();
  }
}

template <int D>
int launch_dq_sm90(int B, int H, int Tq, int Tk, const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta, void* dq,
                   const void* q_ids, const void* k_ids, const long long* s, int out_f32,
                   int causal, int q_off, int k_off, int window, float scale,
                   cudaStream_t stream) {
  using C = Sm90Cfg<D>;
  constexpr auto seg = flash_bwd_dq_sm90<D, true>;
  constexpr auto plain = flash_bwd_dq_sm90<D, false>;
  if (int err = q_ids ? prepare<seg>(C::DQ_SMEM) : prepare<plain>(C::DQ_SMEM)) return err;
  CUtensorMap mq, mk, mv, mdo;
  if (int err = tensor_map(&mq, q, B, Tq, H, D, strides_at(s, 0), C::QBM)) return err;
  if (int err = tensor_map(&mk, k, B, Tk, H, D, strides_at(s, 1), C::QBN)) return err;
  if (int err = tensor_map(&mv, v, B, Tk, H, D, strides_at(s, 2), C::QBN)) return err;
  if (int err = tensor_map(&mdo, dout, B, Tq, H, D, strides_at(s, 3), C::QBM)) return err;
  dim3 grid((Tq + C::QBM - 1) / C::QBM, B * H);
  (q_ids ? seg : plain)<<<grid, C::NT, C::DQ_SMEM, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)delta, dq, (const int*)q_ids,
      (const int*)k_ids, strides_at(s, 4), out_f32, H, Tq, Tk, causal, q_off, k_off, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(int B, int H, int Tq, int Tk, const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* delta, void* dq,
              const void* q_ids, const void* k_ids, const long long* s, int out_f32,
              int causal, int q_off, int k_off, int window, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_dq_sm90<D>(B, H, Tq, Tk, q, k, v, dout, lse, delta, dq, q_ids, k_ids, s,
                             out_f32, causal, q_off, k_off, window, scale, stream);
  } else {
    using C = Cfg<T, D>;
    constexpr auto seg = flash_bwd_dq_kernel<T, D, true>;
    constexpr auto plain = flash_bwd_dq_kernel<T, D, false>;
    if (int err = q_ids ? prepare<seg>(C::DQ_SMEM) : prepare<plain>(C::DQ_SMEM)) return err;
    dim3 grid((Tq + C::BM - 1) / C::BM, B * H);
    (q_ids ? seg : plain)<<<grid, C::NT, C::DQ_SMEM, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
        (const float*)delta, (float*)dq, (const int*)q_ids, (const int*)k_ids, strides_at(s, 0),
        strides_at(s, 1), strides_at(s, 2), strides_at(s, 3), strides_at(s, 4), H, Tq, Tk,
        causal, q_off, k_off, window, scale);
    return (int)cudaGetLastError();
  }
}

template <int D>
int launch_dkv_sm90(int B, int H, int Tq, int Tk, const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                    const void* q_ids, const void* k_ids, const long long* s, int out_f32,
                    int causal, int q_off, int k_off, int window, float scale,
                    cudaStream_t stream) {
  using C = Sm90Cfg<D>;
  constexpr auto seg = flash_bwd_dkv_sm90<D, true>;
  constexpr auto plain = flash_bwd_dkv_sm90<D, false>;
  if (int err = q_ids ? prepare<seg>(C::DKV_SMEM) : prepare<plain>(C::DKV_SMEM)) return err;
  CUtensorMap mq, mk, mv, mdo;
  if (int err = tensor_map(&mq, q, B, Tq, H, D, strides_at(s, 0), C::BBQ)) return err;
  if (int err = tensor_map(&mk, k, B, Tk, H, D, strides_at(s, 1), C::BBN)) return err;
  if (int err = tensor_map(&mv, v, B, Tk, H, D, strides_at(s, 2), C::BBN)) return err;
  if (int err = tensor_map(&mdo, dout, B, Tq, H, D, strides_at(s, 3), C::BBQ)) return err;
  dim3 grid((Tk + C::BBN - 1) / C::BBN, B * H);
  (q_ids ? seg : plain)<<<grid, C::NT, C::DKV_SMEM, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)delta, dk, dv, (const int*)q_ids,
      (const int*)k_ids, strides_at(s, 4), strides_at(s, 5), out_f32, H, Tq, Tk, causal, q_off,
      k_off, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(int B, int H, int Tq, int Tk, const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta, void* dk, void* dv,
               const void* q_ids, const void* k_ids, const long long* s, int out_f32,
               int causal, int q_off, int k_off, int window, float scale,
               cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_dkv_sm90<D>(B, H, Tq, Tk, q, k, v, dout, lse, delta, dk, dv, q_ids, k_ids, s,
                              out_f32, causal, q_off, k_off, window, scale, stream);
  } else {
    using C = Cfg<T, D>;
    constexpr auto seg = flash_bwd_dkv_kernel<T, D, true>;
    constexpr auto plain = flash_bwd_dkv_kernel<T, D, false>;
    if (int err = q_ids ? prepare<seg>(C::DKV_SMEM) : prepare<plain>(C::DKV_SMEM)) return err;
    dim3 grid((Tk + C::BM - 1) / C::BM, B * H);
    (q_ids ? seg : plain)<<<grid, C::NT, C::DKV_SMEM, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
        (const float*)delta, (float*)dk, (float*)dv, (const int*)q_ids, (const int*)k_ids,
        strides_at(s, 0), strides_at(s, 1), strides_at(s, 2), strides_at(s, 3),
        strides_at(s, 4), strides_at(s, 5), H, Tq, Tk, causal, q_off, k_off, window, scale);
    return (int)cudaGetLastError();
  }
}


}  // namespace

// The four (dtype, head dim) instantiations of one launcher.
#define HVD_DISPATCH(launcher, ...)                                       \
  if (dtype == 1 && D == 64) return launcher<bf16, 64>(__VA_ARGS__);      \
  if (dtype == 1 && D == 128) return launcher<bf16, 128>(__VA_ARGS__);    \
  if (dtype == 0 && D == 64) return launcher<float, 64>(__VA_ARGS__);     \
  if (dtype == 0 && D == 128) return launcher<float, 128>(__VA_ARGS__);   \
  return kUnsupported

// C interface, bound with ctypes (horovod_tpu_torch/ops/_build.py).
// dtype: 0 = fp32, 1 = bf16. `strides` holds (b, t, h) element strides of
// each tensor argument in order. Null q_ids/k_ids: no segment ids. Forward
// modes: lse set = train; m and l set = state (o is fp32). out_f32: the
// backward kernels write fp32 outputs. Returns 0 or the cudaError_t of the
// launch (-1 for an unsupported dtype/D pair, -2 for a refused tensor map).
extern "C" {

const char* hvd_error_string(int err) {
  if (err == kTensorMapRefused)
    return "cuTensorMapEncodeTiled refused a tensor map (pointer or strides not 16-byte aligned, "
           "or no driver entry point)";
  return cudaGetErrorString((cudaError_t)err);
}

int hvd_flash_fwd(int dtype, int D, int B, int H, int Tq, int Tk, const void* q,
                  const void* k, const void* v, void* o, void* lse, void* m, void* l,
                  const void* q_ids, const void* k_ids, const long long* strides, int causal,
                  int q_off, int k_off, int window, float scale, void* stream) {
  HVD_DISPATCH(launch_fwd, B, H, Tq, Tk, q, k, v, o, lse, m, l, q_ids, k_ids, strides, causal,
               q_off, k_off, window, scale, (cudaStream_t)stream);
}

// Keys per tile of the forward kernel (P is rounded to bf16 against the
// running max of each such tile), or -1 for an unsupported pair.
int hvd_flash_fwd_key_tile(int dtype, int D) {
  if (dtype == 1 && D == 64) return Sm90Cfg<64>::FBN;
  if (dtype == 1 && D == 128) return Sm90Cfg<128>::FBN;
  if (dtype == 0 && D == 64) return Cfg<float, 64>::BM;
  if (dtype == 0 && D == 128) return Cfg<float, 128>::BM;
  return kUnsupported;
}

int hvd_flash_bwd_dq(int dtype, int D, int B, int H, int Tq, int Tk, const void* q,
                     const void* k, const void* v, const void* dout, const void* lse,
                     const void* delta, void* dq, const void* q_ids, const void* k_ids,
                     const long long* strides, int out_f32, int causal, int q_off, int k_off,
                     int window, float scale, void* stream) {
  HVD_DISPATCH(launch_dq, B, H, Tq, Tk, q, k, v, dout, lse, delta, dq, q_ids, k_ids, strides,
               out_f32, causal, q_off, k_off, window, scale, (cudaStream_t)stream);
}

int hvd_flash_bwd_dkv(int dtype, int D, int B, int H, int Tq, int Tk, const void* q,
                      const void* k, const void* v, const void* dout, const void* lse,
                      const void* delta, void* dk, void* dv, const void* q_ids,
                      const void* k_ids, const long long* strides, int out_f32, int causal,
                      int q_off, int k_off, int window, float scale, void* stream) {
  HVD_DISPATCH(launch_dkv, B, H, Tq, Tk, q, k, v, dout, lse, delta, dk, dv, q_ids, k_ids,
               strides, out_f32, causal, q_off, k_off, window, scale, (cudaStream_t)stream);
}

}  // extern "C"
