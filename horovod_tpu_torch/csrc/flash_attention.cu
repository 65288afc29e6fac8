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
// predicate). Segment ids are a template flag (SEG), so a call without
// them runs no id code. The 16-bit kernels cull by document too: ahead of
// them a small kernel (flash_id_table) writes each side's id table, the
// ids padded to whole tiles and each 64-token tile's [min, max]; a tile
// whose range misses the rows' range holds no pair of one id, so its P is
// exactly 0 and skipping it changes no bit of any output (in the forward
// such a tile's row max is -inf, so it rescales nothing and adds nothing).
// One call's tables serve all its kernels: the training forward builds
// them and both backward kernels read them. In state mode a block whose
// every tile is culled (a future block of the ring, or rows whose
// document has no key in the block) still writes m = -1e30, l = 0 and
// acc = 0, the state the merge expects.
//
// Bounds on an H100 SXM (989 TFLOP/s bf16 and fp16, 3.35 TB/s). At the
// slice's shape (B=8, T=1024, H=12, D=64, causal, bf16, one layer) the
// forward needs ~12.9 GFLOP over the visible pairs (13 us) and moves ~50 MB
// (15 us): bound by bytes; dQ needs 1.5 times its operations (20 us) and
// dK/dV twice (26 us) over ~76 MB. At the ring's past block (Tq = Tk =
// 2048, every pair visible) the state mode needs ~103 GFLOP (104 us), dQ
// with an fp32 output ~155 GFLOP (156 us) and dK/dV ~206 GFLOP (208 us):
// all bound by operations. With segment ids the bound counts only the
// pairs inside the documents: at the packed long-context trainer's
// full-sequence shape (B=2, T=8192, 6 heads of 64, 3 documents) dQ needs
// 52 us and dK/dV 70 us, by operations; the id table reads the 2 B T ids
// and writes them back with their ranges, well under a microsecond. At 4
// heads of 512 (B=4, T=2048, causal) the forward needs 69 us, dQ 104 us and
// dK/dV 139 us, by operations at the true D; the chunked kernels do 1.5
// times the forward's products and 1.67 times dQ's (S and dP once a chunk).
//
// bf16 and fp16 inputs run three kernels of one design, templated on the
// element type E: flash_fwd_sm90 (every forward mode), flash_bwd_dq_sm90
// and flash_bwd_dkv_sm90. Each CTA is three warpgroups: two consumers of
// 64 rows each and one producer. What the design does about what bounds
// attention on this card:
//  1. Products run as wgmma with fp32 accumulators in registers. The score
//     tiles (S = Q.K^T; dQ also dP = dO.V^T; dK/dV S^T = K.Q^T and dP^T =
//     V.dO^T) read both operands from shared memory, K-major. P (dQ: dS;
//     dK/dV: P^T and dS^T), rounded to E where the Pallas kernels round
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
//  3. Shared memory holds only 16-bit tiles and ids: the forward a 128-row Q
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
//  6. Segment ids, in all three kernels. Each CTA narrows its
//     causal/window range of streamed tiles to the first through the
//     last whose id range meets its own rows' (a warp ballot over the
//     table, 32 tiles a vote, by the producer warp and every consumer
//     warp alike): for ids that never decrease along a row, as a packer
//     writes them, exactly the tiles that hold a pair; the tiles between
//     stay visited and masked, so padding or an id that comes back later
//     in the row is still served. A CTA left with no tile loads nothing
//     and writes what a row with no key gets (dQ, dK, dV and O zero; lse
//     +1e30; the empty state). The producer classes each streamed tile
//     for each consumer warpgroup (tile_class, passed in shared memory
//     with the stage): all one id, the same as the warpgroup's rows,
//     takes the id-free path, masked only at a ragged edge or by
//     causality; no id in the rows' range is skipped (every P is 0; the
//     forward's state is left as it is); only a mixed tile compares ids
//     pair by pair, and only it has its ids in shared memory, brought by
//     one bulk copy counted on the stage's full barrier (256 or 512
//     bytes) rather than by the producer's lanes. The elementwise work
//     per score, not the tensor cores, sets these kernels' time, so a
//     tile that needs no mask runs a loop compiled without one
//     (tile_probs in the backward, where the mask zeroes P; the forward
//     masks scores before the row max and runs tile_mask only on a tile
//     that needs it): no per-element test or branch.
//
// fp16 (E = __half) runs the bf16 design unchanged: wgmma takes
// .f32.f16.f16 with the same operand and fragment layouts, the TMA maps
// read FLOAT16, and the register A fragments and 16-bit stores pack
// __half2. What is stored in fp16, where it overflows at 65504 and bf16
// does not: P (P <= 1, bounded), dS (dS = P (dP - delta) scale, rounded as
// the Pallas kernels round it, ds.astype(k.dtype)), and the outputs O, dQ,
// dK and dV in the inputs' dtype (the Pallas kernels' outputs too). Every
// sum, the row statistics and the state mode's accumulator stay fp32.
//
// fp32 inputs keep a simpler design by choice (fp32 stays fp32, with no
// TF32 rounding; the model runs in bf16): one CTA owns one 64-row tile (32
// rows at D_T 128 and 256) and loops over the tiles of the other
// dimension, each warp a 16-row strip of every per-tile matrix, its
// products an FMA loop through shared memory.
//
// Head dims. Every kernel takes any head dim D >= 1 (D a multiple of 8 in
// 16-bit types and of 4 in fp32, so that a row is whole 16-byte words; the
// wrapper pads a copy of other widths). Each is instantiated at three tile
// widths D_T = 64, 128 and 256 and runs D up to 256 at the smallest that
// holds it, with the true D at run time: the tensor maps have D as their
// inner extent, so TMA fills the columns of a tile past D with zeros (a
// 64-column box wholly past D too), and the fp32 loads zero them; zero
// columns leave every product exact. The softmax scale is the caller's
// (1/sqrt(D)), and every store stops at column D: in [B, T, H, D] a
// column past D is the next head's. At D_T = 256 the 16-bit rows are 512
// bytes and the tiles shrink to fit 227 KB of shared memory and the
// consumers' 232 registers: the forward streams 64-key tiles (Q 64 KB +
// two stages of K/V 128 KB), dQ 32-key tiles (Q and dO 128 KB + 64 KB),
// and dK/dV, whose dK and dV of 64 keys would take 256 registers a thread,
// gives both consumer warpgroups the same 64 keys: each computes S^T and
// dP^T over the whole head dim and owns half of dK and dV's columns, on
// 32-query tiles. Products of N = 256 (P.V, dS.K) issue one m64n128k16 per
// half.
//
// Past 256 three limits meet: wgmma's N tops out at 256, a consumer's
// registers hold at most a 64 x 256 fp32 accumulator (with S, dP and the
// fragments beside it), and one 128-row tile of D 512 in bf16 is already
// 128 KB of the 227. So every kernel splits its output's columns into
// chunks of 256 on the grid (blockIdx.z), and a CTA owns one chunk: of O
// in the forward, of dQ in dQ, of dK and dV in dK/dV. The reductions over
// D (S = Q.K^T, and the backward's dP = dO.V^T) run over the whole head
// dim in slabs, adding into the same accumulator (the 16-bit kernels'
// wgmma scale_d = 1 across slabs, the fp32 kernels' sums through shared
// memory): the 16-bit kernels' WIDE instantiation (Sm90Wide) streams, for
// every streamed tile, one ring stage per 128-column slab with both
// operands' slab, then one stage with the chunk's columns of the operand
// the output's product reads (forward V, dQ K, dK/dV Q and dO); the fp32
// kernels load the slabs in turn. Nothing stays resident, so a CTA's own
// rows come again from L2 with every streamed tile, and each chunk
// recomputes S (and dP): those products cost the number of chunks times
// their work, a cost the bound (the function's work at the true D) does
// not count. Every chunk computes the row statistics (lse, m, l) alike,
// and chunk 0 writes them (a build with -DHVD_STATS_LAST_CHUNK has the
// last chunk write them: chip_smoke.py holds the two builds' statistics
// bitwise equal). The alternative, the accumulator in shared memory, would
// hold 64 x D fp32 per consumer (128 KB at D 512) and still need Q in
// slabs past D 256, so it buys no recompute saving for the shared memory
// it takes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, t, h;  // element strides of a [B, T, H, D] tensor
};

// Whether this CTA's chunk of output columns writes the row statistics
// (lse, m, l), which every chunk computes alike: chunk 0, or the last in a
// build with -DHVD_STATS_LAST_CHUNK.
__device__ __forceinline__ bool writes_row_stats() {
#ifdef HVD_STATS_LAST_CHUNK
  return blockIdx.z == gridDim.z - 1;
#else
  return blockIdx.z == 0;
#endif
}

// One fp32 output row of D values from a fp32 shared row.
__device__ __forceinline__ void store_row(float* row, const float* src, int lane, int D) {
  for (int d = lane; d < D; d += 32) row[d] = src[d];
}

__host__ __device__ constexpr int align128(int x) { return (x + 127) & ~127; }

// Tile geometry of the fp32 kernels at tile width DT. BM rows per tile (of
// Q and of K alike); one warp per 16-row strip. Leading dimensions are
// padded against bank conflicts.
template <typename T, int DT>
struct Cfg {
  static_assert(std::is_same<T, float>::value, "16-bit inputs run the sm90 kernels");
  static constexpr int BM = DT == 64 ? 64 : 32;
  static constexpr int NW = BM / 16;
  static constexpr int NT = NW * 32;
  static constexpr int LDT = DT + 4;  // [BM][DT] input tiles
  static constexpr int LDF = DT + 4;  // [BM][DT] accumulators
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

// C[16][N] = A[16][K] . B[N][K]^T for this warp's strip, by FMA; with
// `add`, C += (a later slab of the head dim).
template <typename T, int N, int K>
__device__ __forceinline__ void warp_gemm_nt(const T* A, int lda, const T* B, int ldb,
                                             float* C, int ldc, bool add = false) {
  const int lane = threadIdx.x & 31;
  for (int idx = lane; idx < 16 * N; idx += 32) {
    const int i = idx / N, n = idx % N;
    float acc = add ? C[i * ldc + n] : 0.0f;
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

// Rows [row0, row0 + BM) of one (b, h) slice into a [BM][ld] shared tile
// of DT columns, 16 bytes per thread per step; rows at or past `rows` and
// columns at or past D (a multiple of 16 bytes) are zero-filled.
template <typename T, int DT, int BM, int NT>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* base, long long st,
                                          int row0, int rows, int D) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CPR = DT / VEC;
  for (int c = threadIdx.x; c < BM * CPR; c += NT) {
    const int r = c / CPR, col = (c % CPR) * VEC;
    const int t = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < rows && col < D)
      val = *reinterpret_cast<const uint4*>(base + (long long)t * st + col);
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

// Tile geometry of the bf16 kernels at tile width DT (head dims up to
// DT): two consumer warpgroups of 64 rows each and one producer warpgroup.
template <int DT>
struct Sm90Cfg {
  static_assert(DT == 64 || DT == 128 || DT == 256, "tile widths 64, 128, 256");
  static constexpr int CW = 2;              // consumer warpgroups
  static constexpr int NT = (CW + 1) * WG;  // threads per CTA
  static constexpr int STAGES = 2;          // depth of the streamed-tile ring
  static constexpr int ROW_BYTES = DT * 2;  // one bf16 row
  // Forward: FBM query rows per CTA, FBN keys per streamed tile (64 at
  // DT=256, so that Q and two stages of K/V fit 227 KB).
  static constexpr int FBM = 64 * CW;
  static constexpr int FBN = DT == 256 ? 64 : 128;
  static constexpr int FWD_Q = FBM * ROW_BYTES;
  static constexpr int FWD_KV = FBN * ROW_BYTES;
  static constexpr int FWD_SMEM = FWD_Q + 2 * STAGES * FWD_KV + STAGES * FBN * 4 + 1024 + 1024;
  // dQ: QBM query rows per CTA, QBN keys per streamed tile. Consumers hold
  // dQ (DT / 2 floats), S and dP (QBN / 2 each) and the dS fragments
  // (QBN / 4 words): 128-key tiles at D=128 would need ~224 and spill. At
  // DT=256 Q and dO take 128 KB, so the K/V stages take 32 keys.
  static constexpr int QBM = 64 * CW;
  static constexpr int QBN = DT == 64 ? 128 : DT == 128 ? 64 : 32;
  static constexpr int DQ_Q = QBM * ROW_BYTES;
  static constexpr int DQ_KV = QBN * ROW_BYTES;
  static constexpr int DQ_SMEM = 2 * DQ_Q + 2 * STAGES * DQ_KV + STAGES * QBN * 4 + 1024 + 1024;
  // dK/dV: BBN keys per CTA, BBQ queries per streamed tile; each consumer
  // warpgroup holds DKV_N columns of dK and of dV. Below DT=256 each owns
  // 64 keys and every column; at DT=256 (SPLIT) both own the same 64 keys
  // and half the columns each, on 32-query tiles (registers: 64 + 64 for
  // dK and dV, 16 + 16 for S^T and dP^T, 16 of fragments).
  static constexpr bool SPLIT = DT == 256;
  static constexpr int BBN = SPLIT ? 64 : 64 * CW;
  static constexpr int BBQ = SPLIT ? 32 : 64;
  static constexpr int DKV_N = SPLIT ? DT / CW : DT;
  static constexpr int DKV_KV = BBN * ROW_BYTES;
  static constexpr int DKV_Q = BBQ * ROW_BYTES;
  static constexpr int DKV_SMEM =
      2 * DKV_KV + 2 * STAGES * DKV_Q + 3 * STAGES * BBQ * 4 + 1024 + 1024;
};

// Head dims past 256 (the kernels' WIDE instantiation, at Sm90Cfg<256>'s
// tiles): blockIdx.z is a chunk of CHUNK output columns, and the products
// over the head dim (S, and in the backward dP) run in slabs of SW columns
// through a ring of stages. For each streamed tile the producer fills one
// stage per slab with that slab of both operands (the CTA's own rows and
// the streamed tile's), then one stage with the chunk's columns of the
// operand the output's product reads (forward: V; dQ: K; dK/dV: Q and dO),
// with the tile's ids, class and row statistics. Nothing stays resident:
// the CTA's own rows come again with every streamed tile, from L2.
struct Sm90Wide {
  using C = Sm90Cfg<256>;
  static constexpr int CHUNK = 256, SW = 128;
  // Forward: Q (FBM x SW) and K (FBN x SW) a slab, V (FBN x CHUNK) last.
  static constexpr int FWD_ST = 4;
  static constexpr int FWD_STAGE = (C::FBM + C::FBN) * SW * 2;
  static_assert(FWD_STAGE >= C::FBN * CHUNK * 2, "the V chunk fits a stage");
  static constexpr int FWD_SMEM = FWD_ST * FWD_STAGE + FWD_ST * C::FBN * 4 + 1024 + 1024;
  // dQ: Q and dO (QBM x SW), K and V (QBN x SW) a slab, K (QBN x CHUNK) last.
  static constexpr int DQ_ST = 2;
  static constexpr int DQ_STAGE = (2 * C::QBM + 2 * C::QBN) * SW * 2;
  static constexpr int DQ_SMEM = DQ_ST * DQ_STAGE + DQ_ST * C::QBN * 4 + 1024 + 1024;
  // dK/dV: K and V (BBN x SW), Q and dO (BBQ x SW) a slab, Q and dO (BBQ x
  // CHUNK) last; each consumer owns half of the chunk's columns (SPLIT).
  static constexpr int DKV_ST = 4;
  static constexpr int DKV_STAGE = (2 * C::BBN + 2 * C::BBQ) * SW * 2;
  static_assert(DKV_STAGE >= 2 * C::BBQ * CHUNK * 2, "the Q and dO chunks fit a stage");
  static constexpr int DKV_SMEM =
      DKV_ST * DKV_STAGE + 3 * DKV_ST * C::BBQ * 4 + 1024 + 1024;
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

// ---- segment ids of the bf16 kernels: the id table -------------------------------

constexpr int ID_TILE = 64;  // tokens per range of the table: a warpgroup's rows
constexpr int ID_ROW = 128;  // the padded ids of a row: a multiple of the widest tile

// One side's id table, in the scratch the wrapper allocates: each batch
// row's ids padded with 0 to a multiple of ID_ROW tokens (so that a tile's
// ids are one aligned bulk copy), then each ID_TILE-token tile's [min, max]
// over its tokens < T.
struct IdTable {
  int* ids;   // [B, pad]
  int2* rng;  // [B, nt]
  int pad, nt;
};

__host__ __device__ inline IdTable id_table(const int* base, int B, int T) {
  IdTable t;
  t.pad = (T + ID_ROW - 1) / ID_ROW * ID_ROW;
  t.nt = (T + ID_TILE - 1) / ID_TILE;
  t.ids = const_cast<int*>(base);
  t.rng = reinterpret_cast<int2*>(t.ids + (long long)B * t.pad);
  return t;
}

// int32 values of one side's table, rounded up to a multiple of 4 so that
// the k side's table, which follows the q side's in the scratch, starts
// 16-byte aligned as the bulk copies of its ids need (B odd with an odd
// number of 64-token tiles leaves the ranges 8 bytes short of that).
// ops/flash_attention.py sizes the scratch by the same sum.
inline long long id_table_ints(int B, int T) {
  const long long n =
      (long long)B * ((T + ID_ROW - 1) / ID_ROW * ID_ROW + 2 * ((T + ID_TILE - 1) / ID_TILE));
  return (n + 3) / 4 * 4;
}

// The id tables of both sides (blockIdx.z: 0 q, 1 k), one warp per tile.
// Replaces no Pallas kernel: the bf16 kernels with ids read it to cull
// tiles and to skip the id compare (see the note at the top). It moves
// each id in once and out about once: bound by bytes, a few microseconds
// at the long-context shapes, launch latency included.
__global__ void __launch_bounds__(256)
    flash_id_table(const int* __restrict__ q_ids, const int* __restrict__ k_ids, int* q_tab,
                   int* k_tab, int B, int Tq, int Tk) {
  const bool kside = blockIdx.z == 1;
  const int* ids = kside ? k_ids : q_ids;
  const int T = kside ? Tk : Tq;
  const IdTable t = id_table(kside ? k_tab : q_tab, B, T);
  const int tile = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32, b = blockIdx.y;
  if (tile * ID_TILE >= t.pad) return;
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int c = lane; c < ID_TILE; c += 32) {
    const int pos = tile * ID_TILE + c;
    const int id = pos < T ? ids[(long long)b * T + pos] : 0;
    if (pos < T) {
      lo = min(lo, id);
      hi = max(hi, id);
    }
    t.ids[(long long)b * t.pad + pos] = id;
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0 && tile < t.nt) t.rng[(long long)b * t.nt + tile] = make_int2(lo, hi);
}

// [min, max] of the ids of tiles [i, i + n) of row b; the empty range
// (min > max) past the row's last tile.
template <int N>
__device__ __forceinline__ int2 id_range(const IdTable& t, int b, int i) {
  int2 r = make_int2(INT_MAX, INT_MIN);
#pragma unroll
  for (int j = i; j < i + N; ++j) {
    if (j >= t.nt) break;
    const int2 e = t.rng[(long long)b * t.nt + j];
    r = make_int2(min(r.x, e.x), max(r.y, e.y));
  }
  return r;
}

// [min, max] of the ids of the N-token tile t of row b: the ranges of the
// ID_TILE-token tiles that cover it (a tile of 32 takes its 64-token
// tile's range, a superset, so its class errs towards comparing ids).
template <int N>
__device__ __forceinline__ int2 tile_ids(const IdTable& tab, int b, int t) {
  return id_range<(N + ID_TILE - 1) / ID_TILE>(tab, b, t * N / ID_TILE);
}

// A streamed tile's class for each of the two consumer warpgroups, two
// bits each from bit 2 w: ONE_ID, the tile and the warpgroup's rows all
// carry one id (no compare); NO_PAIR, no id of the tile is in the rows'
// range (every P is 0: the warpgroup skips the tile). Neither: the ids
// are compared pair by pair, and the producer brings them.
constexpr int ONE_ID = 1, NO_PAIR = 2;

__device__ __forceinline__ int tile_class(int2 t, int2 r0, int2 r1) {
  const auto one = [t](int2 r) {
    if (t.x > r.y || r.x > t.y) return NO_PAIR;
    return t.x == t.y && r.x == r.y && t.x == r.x ? ONE_ID : 0;
  };
  return one(r0) | one(r1) << 2;
}

__device__ __forceinline__ bool compares_ids(int cls) {
  return (cls & 3) == 0 || (cls >> 2 & 3) == 0;
}
__device__ __forceinline__ bool no_pair(int cls) {
  return (cls & NO_PAIR) && (cls >> 2 & NO_PAIR);
}

// Narrows the tiles [lo, hi) to the first through the last one that
// holds a pair for either warpgroup (`cls(t)` its tile_class): a scan by
// the whole warp, 32 tiles a ballot, forward for the first and backward
// for the last. Tiles between the two stay, so any order of ids is served.
template <class F>
__device__ __forceinline__ void narrow(int& lo, int& hi, int lane, F cls) {
  int first = hi, last = lo - 1;
  for (int base = lo; base < hi; base += 32) {
    const unsigned m = __ballot_sync(0xffffffffu, base + lane < hi && !no_pair(cls(base + lane)));
    if (m) {
      first = base + __ffs(m) - 1;
      break;
    }
  }
  for (int top = hi; top > first; top -= 32) {
    const int t = top - 1 - lane;
    const unsigned m = __ballot_sync(0xffffffffu, t >= first && !no_pair(cls(t)));
    if (m) {
      last = top - __ffs(m);
      break;
    }
  }
  lo = first;
  hi = max(first, last + 1);
}

// The class of tile lo + i (of the range a warp walks in order), each
// lane classing one tile in 32: called by the whole warp for every i.
template <class F>
__device__ __forceinline__ int class_at(int i, int lo, int hi, int lane, int& mine, F cls) {
  if (i % 32 == 0 && lo + i + lane < hi) mine = cls(lo + i + lane);
  return __shfl_sync(0xffffffffu, mine, i % 32);
}

// P of one streamed tile in the wgmma accumulator layout: x = p(x, c, r)
// at column c of the thread's row r, and 0 where MASK and not ok(c, r).
// The backward kernels with ids take the instantiation without a mask
// for a tile that needs none, so a tile inside one document, off the
// causal diagonal, runs no per-element test.
template <int N, bool MASK, class P, class Ok>
__device__ __forceinline__ void tile_probs(float (&x)[N / 2], int lane, P p, Ok ok) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * (lane % 4) + (e & 1), r = e >> 1;
      float v = p(x[4 * j + e], c, r);
      if (MASK && !ok(c, r)) v = 0.0f;
      x[4 * j + e] = v;
    }
}

// The forward's counterpart of tile_probs, which masks scores before the
// row max rather than P: x = -inf at column c of the thread's row r where
// not ok(c, r). The forward with ids calls it only for a tile that needs
// a mask, and with the id compare only in a tile that mixes ids.
template <int N, class Ok>
__device__ __forceinline__ void tile_mask(float (&x)[N / 2], int lane, Ok ok) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!ok(8 * j + 2 * (lane % 4) + (e & 1), e >> 1)) x[4 * j + e] = -INFINITY;
}

// A [rows][DT] tile of 16-bit values at (row0, h, b), from column col0 on,
// into shared memory as DT / 64 swizzled [rows][64] tiles, one TMA box
// each; columns past the map's head dim arrive as zeros, and each box
// counts its full bytes.
template <int DT, class E>
__device__ __forceinline__ void tma_tile(E* dst, int rows, const CUtensorMap* map,
                                         uint64_t* bar, int h, int row0, int b, int col0 = 0) {
#pragma unroll
  for (int c = 0; c < DT / 64; ++c)
    hopper::tma_load_4d(dst + c * rows * 64, map, bar, col0 + 64 * c, h, row0, b);
}

// Descriptor of the K-major operand rows [row0, row0 + 64) of a [rows][D]
// tile at k step k (16 columns).
template <class E>
__device__ __forceinline__ uint64_t kmajor(const E* tile, int rows, int row0, int k) {
  return hopper::desc_sw128(tile + (k / 4) * rows * 64 + row0 * 64 + (k % 4) * 16, 16, 1024);
}

// Descriptor of the MN-major operand rows [16 k, 16 k + 16) of a [rows][D]
// tile (the rows are the reduction dim, D the N dim).
template <class E>
__device__ __forceinline__ uint64_t mnmajor(const E* tile, int rows, int k) {
  return hopper::desc_sw128(tile + k * 16 * 64, rows * 128, 1024);
}

// The register A operand of k step kk from an accumulator-layout array,
// rounded to E.
template <class E, int N>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&x)[N], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = hopper::pack2<E>(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// acc[64 x N] += A . B at k step kk: A a register fragment, B columns
// [0, N) of a [rows][..] tile read MN-major. wgmma's N tops out at 128
// here, so N = 256 issues one product per 128-column half (the halves'
// accumulators are acc[0, 64) and acc[64, 128) in the wgmma layout).
template <int N, class E>
__device__ __forceinline__ void mma_rs(float (&acc)[N / 2], const uint32_t (&a)[4],
                                       const E* tile, int rows, int kk) {
  if constexpr (N <= 128) {
    hopper::wgmma_rs<N, E>(acc, a, mnmajor(tile, rows, kk));
  } else {
#pragma unroll
    for (int half = 0; half < N / 128; ++half)
      hopper::wgmma_rs<128, E>(*reinterpret_cast<float(*)[64]>(acc + 64 * half), a,
                               mnmajor(tile + half * 2 * rows * 64, rows, kk));
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Two adjacent output values through a row pointer, in E or fp32.
template <class E>
__device__ __forceinline__ void store2(void* row, int col, float x, float y, bool f32) {
  if (f32)
    *reinterpret_cast<float2*>(static_cast<float*>(row) + col) = make_float2(x, y);
  else
    *reinterpret_cast<uint32_t*>(static_cast<E*>(row) + col) = hopper::pack2<E>(x, y);
}

// A thread's two rows (t0 and t0 + 8) of a 64 x N accumulator in the
// wgmma layout into columns [col0, col0 + N) of a [B, T, H, D] output with
// strides `so`, in E or fp32; rows at or past T and columns at or past
// D (a multiple of 8: whole 8-column chunks) are not stored.
template <int N, class E>
__device__ __forceinline__ void store_acc(void* out, Strides so, int b, int h, int t0, int T,
                                          const float (&acc)[N / 2], bool f32, int lane,
                                          int col0, int D) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + 8 * r;
    if (t >= T) continue;
    unsigned char* row = static_cast<unsigned char*>(out) +
                         (b * so.b + (long long)t * so.t + h * so.h) * (f32 ? 4 : 2);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      if (col0 + 8 * j < D)
        store2<E>(row, col0 + 8 * j + 2 * (lane % 4), acc[4 * j + 2 * r],
                  acc[4 * j + 2 * r + 1], f32);
  }
}

// The producer warp's K/V stream without ids: key tiles [lo, hi) of BN
// keys through the ST stages of sK/sV, each stage handed to the consumers
// on full[s] and taken back on empty[s].
template <int DT, int BN, int ST, class E>
__device__ __forceinline__ void stream_kv(E* sK, E* sV, uint64_t* full, uint64_t* empty,
                                          const CUtensorMap* mk, const CUtensorMap* mv, int b,
                                          int h, int lo, int hi, int lane) {
  for (int i = 0; i < hi - lo; ++i) {
    const int s = i % ST, k0 = (lo + i) * BN;
    if (i >= ST) hopper::mbar_wait(&empty[s], (i / ST - 1) & 1);
    if (lane == 0) {
      hopper::mbar_expect_tx(&full[s], 2 * BN * DT * 2);
      tma_tile<DT>(sK + s * BN * DT, BN, mk, &full[s], h, k0, b);
      tma_tile<DT>(sV + s * BN * DT, BN, mv, &full[s], h, k0, b);
    } else {
      hopper::mbar_arrive(&full[s]);
    }
  }
}

// The K/V stream with segment ids (the forward's and dQ's): key tiles
// [lo, hi) as stream_kv, each
// stage's tile_class in sCls[s], and the tile's padded ids by one bulk
// copy on full[s] where a consumer warpgroup compares them.
template <int DT, int BN, int ST, class E, class F>
__device__ __forceinline__ void stream_kv_ids(E* sK, E* sV, int* sKid, int* sCls,
                                              uint64_t* full, uint64_t* empty,
                                              const CUtensorMap* mk, const CUtensorMap* mv,
                                              const IdTable& ktab, int b, int h, int lo, int hi,
                                              int lane, F cls) {
  int mine = 0;
  for (int i = 0; i < hi - lo; ++i) {
    const int s = i % ST, k0 = (lo + i) * BN;
    const int c = class_at(i, lo, hi, lane, mine, cls);
    if (i >= ST) hopper::mbar_wait(&empty[s], (i / ST - 1) & 1);
    if (lane == 0) {
      const bool ids = compares_ids(c);
      sCls[s] = c;
      hopper::mbar_expect_tx(&full[s], 2 * BN * DT * 2 + (ids ? BN * 4 : 0));
      tma_tile<DT>(sK + s * BN * DT, BN, mk, &full[s], h, k0, b);
      tma_tile<DT>(sV + s * BN * DT, BN, mv, &full[s], h, k0, b);
      if (ids)
        hopper::bulk_load(sKid + s * BN, ktab.ids + (long long)b * ktab.pad + k0, BN * 4,
                          &full[s]);
    } else {
      hopper::mbar_arrive(&full[s]);
    }
  }
}

// 16-bit forward (E: bf16 or fp16). One CTA owns FBM query rows of one
// (b, h); the producer warp loads Q once and streams K/V tiles (and, with
// SEG, their classes and a mixed tile's ids) through the ring; each
// consumer warpgroup runs the online softmax for its 64 rows with S and O
// in registers. A CTA that sees no key tile (a future block of the ring,
// or rows whose documents have no key here) loads nothing and writes the
// empty rows. Modes as in flash_fwd_kernel. DT: the tile width; D <= DT
// the head dim, or with WIDE (DT = 256) any D: blockIdx.z's chunk of O,
// S over Sm90Wide's slabs, and the row statistics written by the chunk
// writes_row_stats() picks (every chunk computes them alike).
template <class E, int DT, bool SEG, bool WIDE>
__global__ void __launch_bounds__(Sm90Cfg<DT>::NT, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, void* __restrict__ o,
                   float* __restrict__ lse, float* __restrict__ m_out, float* __restrict__ l_out,
                   const int* __restrict__ q_ids, const int* __restrict__ k_ids, Strides so,
                   int D, int H, int Tq, int Tk, int causal, int q_off, int k_off, int window,
                   float scale) {
  using C = Sm90Cfg<DT>;
  using W = Sm90Wide;
  static_assert(!WIDE || DT == W::CHUNK, "WIDE runs at the 256 tile width");
  constexpr int BM = C::FBM, BN = C::FBN, ST = WIDE ? W::FWD_ST : C::STAGES, SW = W::SW;
  constexpr int TILES = WIDE ? ST * W::FWD_STAGE : C::FWD_Q + 2 * ST * C::FWD_KV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  E* sQ = reinterpret_cast<E*>(smem);
  E* sK = reinterpret_cast<E*>(smem + C::FWD_Q);
  E* sV = reinterpret_cast<E*>(smem + C::FWD_Q + ST * C::FWD_KV);
  int* sKid = reinterpret_cast<int*>(smem + TILES);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKid + ST * BN);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;
  [[maybe_unused]] int* sCls = reinterpret_cast<int*>(empty + ST);  // SEG: tile_class

  const int nqt = (Tq + BM - 1) / BM;
  const int qt = causal ? nqt - 1 - blockIdx.x : blockIdx.x;  // longest rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row0 = qt * BM, q_base = q_off + row0;
  int lo, hi;
  key_tiles(q_base, BM, k_off, BN, (Tk + BN - 1) / BN, causal, window, lo, hi);
  const int wg = threadIdx.x / WG;
  // WIDE: this CTA's columns of O from c0, and the slabs of the head dim.
  const int c0 = WIDE ? blockIdx.z * W::CHUNK : 0, ns = (D + SW - 1) / SW;
  // SEG: q_ids and k_ids are the id tables; a key tile's class.
  const IdTable qtab = id_table(q_ids, gridDim.y / H, Tq);
  const IdTable ktab = id_table(k_ids, gridDim.y / H, Tk);
  [[maybe_unused]] const auto key_class = [&](int kt) {
    return tile_class(tile_ids<BN>(ktab, b, kt), id_range<1>(qtab, b, row0 / ID_TILE),
                      id_range<1>(qtab, b, row0 / ID_TILE + 1));
  };

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
    if constexpr (SEG) {
      if (threadIdx.x / 32 == C::CW * 4) narrow(lo, hi, lane, key_class);
    }
    if (threadIdx.x / 32 != C::CW * 4 || hi == lo) return;
    if (lane == 0) {
      hopper::prefetch_map(&mq);
      hopper::prefetch_map(&mk);
      hopper::prefetch_map(&mv);
      if constexpr (!WIDE) {
        hopper::mbar_expect_tx(q_full, C::FWD_Q);
        tma_tile<DT>(sQ, BM, &mq, q_full, h, row0, b);
      }
    }
    if constexpr (WIDE) {
      // Item n = (ns + 1) i + j of key tile lo + i: slab j of Q and K for
      // j < ns, then the chunk's V with the tile's class and ids.
      [[maybe_unused]] int mine = 0;
      for (int i = 0; i < hi - lo; ++i) {
        const int k0 = (lo + i) * BN;
        int c = 0;
        if constexpr (SEG) c = class_at(i, lo, hi, lane, mine, key_class);
        for (int j = 0; j <= ns; ++j) {
          const int n = i * (ns + 1) + j, s = n % ST;
          if (n >= ST) hopper::mbar_wait(&empty[s], (n / ST - 1) & 1);
          if (lane == 0) {
            E* st = reinterpret_cast<E*>(smem + s * W::FWD_STAGE);
            if constexpr (SEG) sCls[s] = c;
            if (j < ns) {
              hopper::mbar_expect_tx(&full[s], W::FWD_STAGE);
              tma_tile<SW>(st, BM, &mq, &full[s], h, row0, b, SW * j);
              tma_tile<SW>(st + BM * SW, BN, &mk, &full[s], h, k0, b, SW * j);
            } else {
              const bool ids = SEG && compares_ids(c);
              hopper::mbar_expect_tx(&full[s], BN * W::CHUNK * 2 + (ids ? BN * 4 : 0));
              tma_tile<W::CHUNK>(st, BN, &mv, &full[s], h, k0, b, c0);
              if (ids)
                hopper::bulk_load(sKid + s * BN, ktab.ids + (long long)b * ktab.pad + k0, BN * 4,
                                  &full[s]);
            }
          } else {
            hopper::mbar_arrive(&full[s]);
          }
        }
      }
    } else if constexpr (SEG) {
      stream_kv_ids<DT, BN, ST>(sK, sV, sKid, sCls, full, empty, &mk, &mv, ktab, b, h, lo, hi,
                                lane, key_class);
    } else {
      stream_kv<DT, BN, ST>(sK, sV, full, empty, &mk, &mv, b, h, lo, hi, lane);
    }
    return;
  }

  // Consumer warpgroup wg: query rows [64 wg, 64 wg + 64) of the tile.
  hopper::regs_inc<232>();
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  if constexpr (SEG) narrow(lo, hi, lane, key_class);  // the producer's range
  const int wrow0 = 64 * wg;
  const float c2 = scale * LOG2E;
  int qpos[2], qid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tq = row0 + wrow0 + 16 * warp + lane / 4 + 8 * r;
    qpos[r] = q_off + tq;
    qid[r] = SEG && tq < Tq ? qtab.ids[(long long)b * qtab.pad + tq] : 0;
  }
  float acc[DT / 2], sc[BN / 2];
#pragma unroll
  for (int i = 0; i < DT / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.0f;
  float m2[2] = {-INFINITY, -INFINITY}, lsum[2] = {0.0f, 0.0f};  // m2: log2 units

  if constexpr (!WIDE) {
    if (hi > lo) hopper::mbar_wait(q_full, 0);
  }
  for (int i = 0; i < hi - lo; ++i) {
    const int k0 = (lo + i) * BN;
    int s, cls = 0;
    const E* tV;
    if constexpr (WIDE) {
      // S = Q . K^T for this warpgroup's 64 rows, slab by slab; then the
      // stage with the chunk's V (and the tile's ids) is this tile's.
      for (int j = 0; j < ns; ++j) {
        const int n = i * (ns + 1) + j, sj = n % ST;
        const E* st = reinterpret_cast<const E*>(smem + sj * W::FWD_STAGE);
        hopper::mbar_wait(&full[sj], (n / ST) & 1);
        if (SEG && j == 0) cls = (sCls[sj] >> 2 * wg) & 3;
        if (!(cls & NO_PAIR)) {
          hopper::fence_regs(sc);
          hopper::wgmma_fence();
#pragma unroll
          for (int k = 0; k < SW / 16; ++k)
            hopper::wgmma_ss<BN, E>(sc, kmajor(st, BM, wrow0, k), kmajor(st + BM * SW, BN, 0, k),
                                    j > 0 || k > 0);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(sc);
        }
        hopper::mbar_arrive(&empty[sj]);
      }
      const int n = i * (ns + 1) + ns;
      s = n % ST;
      tV = reinterpret_cast<const E*>(smem + s * W::FWD_STAGE);
      hopper::mbar_wait(&full[s], (n / ST) & 1);
      if (cls & NO_PAIR) {  // no pair of one id in these rows: the state stays
        hopper::mbar_arrive(&empty[s]);
        continue;
      }
    } else {
      s = i % ST;
      const E* tK = sK + s * BN * DT;
      tV = sV + s * BN * DT;
      hopper::mbar_wait(&full[s], (i / ST) & 1);
      cls = SEG ? (sCls[s] >> 2 * wg) & 3 : 0;
      if (cls & NO_PAIR) {  // no pair of one id in these rows: the state stays
        hopper::mbar_arrive(&empty[s]);
        continue;
      }

      // S = Q . K^T for this warpgroup's 64 rows.
      hopper::fence_regs(sc);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < DT / 16; ++k)
        hopper::wgmma_ss<BN, E>(sc, kmajor(sQ, BM, wrow0, k), kmajor(tK, BN, 0, k), k > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
    }

    // The score mask, before the row max: at a ragged edge or by
    // causality/window; ids are compared only in a tile that mixes them.
    const bool edge =
        k0 + BN > Tk || !all_visible(q_base + wrow0, 64, k_off + k0, BN, causal, window);
    if constexpr (SEG) {
      const auto seen = [&](int c, int r) {
        return k0 + c < Tk && visible_pair(qpos[r], k_off + k0 + c, causal, window);
      };
      const int* kid = sKid + s * BN;
      if (cls == 0)
        tile_mask<BN>(sc, lane, [&](int c, int r) { return seen(c, r) && kid[c] == qid[r]; });
      else if (edge)
        tile_mask<BN>(sc, lane, seen);
    } else if (edge) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * (lane % 4) + (e & 1), r = e >> 1;
          const bool ok = k0 + c < Tk && visible_pair(qpos[r], k_off + k0 + c, causal, window);
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
    for (int j = 0; j < DT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];

    // O += P . V, P rounded to E (V's dtype, as the Pallas kernel).
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) a_frag<E>(pa[kk], sc, kk);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) mma_rs<DT, E>(acc, pa[kk], tV, BN, kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[s]);
  }

  const bool stats = writes_row_stats();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(lsum[r]);
    const int tq = row0 + wrow0 + 16 * warp + lane / 4 + 8 * r;
    if (tq >= Tq) continue;
    void* row = reinterpret_cast<unsigned char*>(o) +
                (b * so.b + (long long)tq * so.t + h * so.h) * (m_out ? 4 : 2);
    const float inv = m_out ? 1.0f : 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < DT / 8; ++j)
      if (c0 + 8 * j < D)
        store2<E>(row, c0 + 8 * j + 2 * (lane % 4), acc[4 * j + 2 * r] * inv,
                  acc[4 * j + 2 * r + 1] * inv, m_out != nullptr);
    if (lane % 4 != 0 || !stats) continue;
    const long long at = (long long)bh * Tq + tq;
    if (m_out != nullptr) {
      m_out[at] = m2[r] == -INFINITY ? NEG_INF : m2[r] * LN2;
      l_out[at] = l;
    } else if (lse != nullptr) {
      lse[at] = l > 0.0f ? (m2[r] + log2f(l)) * LN2 : -NEG_INF;
    }
  }
}

// 16-bit dQ. One CTA owns QBM query rows of one (b, h): the producer warp
// loads Q and dO once, then streams K/V tiles (and, with SEG, their ids)
// through the ring over the key tiles these rows can see; each consumer
// warpgroup keeps dQ of its 64 rows in registers over the whole key loop.
// A CTA that sees no key tile (a future block of the ring) loads nothing
// and writes dQ = 0. WIDE: blockIdx.z's chunk of dQ, with S and dP over
// Sm90Wide's slabs and the chunk's K last for each key tile.
template <class E, int DT, bool SEG, bool WIDE>
__global__ void __launch_bounds__(Sm90Cfg<DT>::NT, 1)
    flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv,
                      const __grid_constant__ CUtensorMap mdo, const float* __restrict__ lse,
                      const float* __restrict__ delta, void* __restrict__ dq,
                      const int* __restrict__ q_ids, const int* __restrict__ k_ids, Strides sdq,
                      int out_f32, int D, int H, int Tq, int Tk, int causal, int q_off, int k_off,
                      int window, float scale) {
  using C = Sm90Cfg<DT>;
  using W = Sm90Wide;
  static_assert(!WIDE || DT == W::CHUNK, "WIDE runs at the 256 tile width");
  constexpr int BM = C::QBM, BN = C::QBN, ST = WIDE ? W::DQ_ST : C::STAGES, SW = W::SW;
  constexpr int TILES = WIDE ? ST * W::DQ_STAGE : 2 * C::DQ_Q + 2 * ST * C::DQ_KV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  E* sQ = reinterpret_cast<E*>(smem);
  E* sDO = reinterpret_cast<E*>(smem + C::DQ_Q);
  E* sK = reinterpret_cast<E*>(smem + 2 * C::DQ_Q);
  E* sV = reinterpret_cast<E*>(smem + 2 * C::DQ_Q + ST * C::DQ_KV);
  int* sKid = reinterpret_cast<int*>(smem + TILES);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKid + ST * BN);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;
  [[maybe_unused]] int* sCls = reinterpret_cast<int*>(empty + ST);  // SEG: tile_class

  const int nqt = (Tq + BM - 1) / BM;
  const int qt = causal ? nqt - 1 - blockIdx.x : blockIdx.x;  // longest rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int row0 = qt * BM, q_base = q_off + row0;
  int lo, hi;
  key_tiles(q_base, BM, k_off, BN, (Tk + BN - 1) / BN, causal, window, lo, hi);
  const int wg = threadIdx.x / WG;
  // WIDE: this CTA's columns of dQ from c0, and the slabs of the head dim.
  const int c0 = WIDE ? blockIdx.z * W::CHUNK : 0, ns = (D + SW - 1) / SW;
  // SEG: q_ids and k_ids are the id tables; a key tile's class.
  const IdTable qtab = id_table(q_ids, gridDim.y / H, Tq);
  const IdTable ktab = id_table(k_ids, gridDim.y / H, Tk);
  [[maybe_unused]] const auto key_class = [&](int kt) {
    return tile_class(tile_ids<BN>(ktab, b, kt), id_range<1>(qtab, b, row0 / ID_TILE),
                      id_range<1>(qtab, b, row0 / ID_TILE + 1));
  };

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
    if constexpr (SEG) {
      if (threadIdx.x / 32 == C::CW * 4) narrow(lo, hi, lane, key_class);
    }
    if (threadIdx.x / 32 != C::CW * 4 || hi == lo) return;
    if (lane == 0) {
      hopper::prefetch_map(&mk);
      hopper::prefetch_map(&mv);
      if constexpr (!WIDE) {
        hopper::mbar_expect_tx(q_full, 2 * C::DQ_Q);
        tma_tile<DT>(sQ, BM, &mq, q_full, h, row0, b);
        tma_tile<DT>(sDO, BM, &mdo, q_full, h, row0, b);
      }
    }
    if constexpr (WIDE) {
      // Item n = (ns + 1) i + j of key tile lo + i: slab j of Q, dO, K and
      // V for j < ns, then the chunk's K with the tile's class and ids.
      [[maybe_unused]] int mine = 0;
      for (int i = 0; i < hi - lo; ++i) {
        const int k0 = (lo + i) * BN;
        int c = 0;
        if constexpr (SEG) c = class_at(i, lo, hi, lane, mine, key_class);
        for (int j = 0; j <= ns; ++j) {
          const int n = i * (ns + 1) + j, s = n % ST;
          if (n >= ST) hopper::mbar_wait(&empty[s], (n / ST - 1) & 1);
          if (lane == 0) {
            E* st = reinterpret_cast<E*>(smem + s * W::DQ_STAGE);
            if constexpr (SEG) sCls[s] = c;
            if (j < ns) {
              hopper::mbar_expect_tx(&full[s], W::DQ_STAGE);
              tma_tile<SW>(st, BM, &mq, &full[s], h, row0, b, SW * j);
              tma_tile<SW>(st + BM * SW, BM, &mdo, &full[s], h, row0, b, SW * j);
              tma_tile<SW>(st + 2 * BM * SW, BN, &mk, &full[s], h, k0, b, SW * j);
              tma_tile<SW>(st + (2 * BM + BN) * SW, BN, &mv, &full[s], h, k0, b, SW * j);
            } else {
              const bool ids = SEG && compares_ids(c);
              hopper::mbar_expect_tx(&full[s], BN * W::CHUNK * 2 + (ids ? BN * 4 : 0));
              tma_tile<W::CHUNK>(st, BN, &mk, &full[s], h, k0, b, c0);
              if (ids)
                hopper::bulk_load(sKid + s * BN, ktab.ids + (long long)b * ktab.pad + k0, BN * 4,
                                  &full[s]);
            }
          } else {
            hopper::mbar_arrive(&full[s]);
          }
        }
      }
    } else if constexpr (SEG) {
      stream_kv_ids<DT, BN, ST>(sK, sV, sKid, sCls, full, empty, &mk, &mv, ktab, b, h, lo, hi,
                                lane, key_class);
    } else {
      stream_kv<DT, BN, ST>(sK, sV, full, empty, &mk, &mv, b, h, lo, hi, lane);
    }
    return;
  }

  // Consumer warpgroup wg: query rows [64 wg, 64 wg + 64) of the tile.
  hopper::regs_inc<232>();
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  if constexpr (SEG) narrow(lo, hi, lane, key_class);  // the producer's range
  const int wrow0 = 64 * wg;
  const float c2 = scale * LOG2E;
  int qpos[2], qid[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tq = row0 + wrow0 + 16 * warp + lane / 4 + 8 * r;
    const bool in = tq < Tq;
    qpos[r] = q_off + tq;
    qid[r] = SEG && in ? qtab.ids[(long long)b * qtab.pad + tq] : 0;
    // A padded row gets lse = +1e30, so exp2(s - lse) is exactly zero.
    lse2[r] = in ? lse[(long long)bh * Tq + tq] * LOG2E : -NEG_INF;
    dlt[r] = in ? delta[(long long)bh * Tq + tq] : 0.0f;
  }
  float dq_acc[DT / 2], sc[BN / 2], dps[BN / 2];
#pragma unroll
  for (int i = 0; i < DT / 2; ++i) dq_acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = dps[i] = 0.0f;

  if constexpr (!WIDE) {
    if (hi > lo) hopper::mbar_wait(q_full, 0);
  }
  for (int i = 0; i < hi - lo; ++i) {
    const int k0 = (lo + i) * BN;
    int s, cls = 0;
    const E* tK;
    if constexpr (WIDE) {
      // S = Q . K^T and dP = dO . V^T slab by slab; then the stage with
      // the chunk's K (and the tile's ids) is this tile's.
      for (int j = 0; j < ns; ++j) {
        const int n = i * (ns + 1) + j, sj = n % ST;
        const E* st = reinterpret_cast<const E*>(smem + sj * W::DQ_STAGE);
        hopper::mbar_wait(&full[sj], (n / ST) & 1);
        if (SEG && j == 0) cls = (sCls[sj] >> 2 * wg) & 3;
        if (!(cls & NO_PAIR)) {
          hopper::fence_regs(sc);
          hopper::fence_regs(dps);
          hopper::wgmma_fence();
#pragma unroll
          for (int k = 0; k < SW / 16; ++k)
            hopper::wgmma_ss<BN, E>(sc, kmajor(st, BM, wrow0, k),
                                    kmajor(st + 2 * BM * SW, BN, 0, k), j > 0 || k > 0);
          hopper::wgmma_commit();
#pragma unroll
          for (int k = 0; k < SW / 16; ++k)
            hopper::wgmma_ss<BN, E>(dps, kmajor(st + BM * SW, BM, wrow0, k),
                                    kmajor(st + (2 * BM + BN) * SW, BN, 0, k), j > 0 || k > 0);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(sc);
          hopper::fence_regs(dps);
        }
        hopper::mbar_arrive(&empty[sj]);
      }
      const int n = i * (ns + 1) + ns;
      s = n % ST;
      tK = reinterpret_cast<const E*>(smem + s * W::DQ_STAGE);
      hopper::mbar_wait(&full[s], (n / ST) & 1);
      if (cls & NO_PAIR) {  // no pair of one id in these rows: every P is 0
        hopper::mbar_arrive(&empty[s]);
        continue;
      }
    } else {
      s = i % ST;
      tK = sK + s * BN * DT;
      const E* tV = sV + s * BN * DT;
      hopper::mbar_wait(&full[s], (i / ST) & 1);
      cls = SEG ? (sCls[s] >> 2 * wg) & 3 : 0;
      if (cls & NO_PAIR) {  // no pair of one id in these rows: every P is 0
        hopper::mbar_arrive(&empty[s]);
        continue;
      }

      // S = Q . K^T and dP = dO . V^T, two groups in flight.
      hopper::fence_regs(sc);
      hopper::fence_regs(dps);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < DT / 16; ++k)
        hopper::wgmma_ss<BN, E>(sc, kmajor(sQ, BM, wrow0, k), kmajor(tK, BN, 0, k), k > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int k = 0; k < DT / 16; ++k)
        hopper::wgmma_ss<BN, E>(dps, kmajor(sDO, BM, wrow0, k), kmajor(tV, BN, 0, k), k > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);
    }

    // P = exp2(S c - lse2) under the masks. Keys past Tk read as zeros
    // (S = 0, P = exp2(-lse2) != 0), so a ragged last tile takes the mask;
    // ids are compared only in a tile that mixes them.
    const bool ids = SEG && cls == 0;
    const bool masked = ids || k0 + BN > Tk ||
                        !all_visible(q_base + wrow0, 64, k_off + k0, BN, causal, window);
    if constexpr (SEG) {
      const auto p = [&](float x, int, int r) { return exp2f(fmaf(x, c2, -lse2[r])); };
      const auto seen = [&](int c, int r) {
        return k0 + c < Tk && visible_pair(qpos[r], k_off + k0 + c, causal, window);
      };
      const int* kid = sKid + s * BN;
      if (masked)
        tile_probs<BN, true>(sc, lane, p, [&](int c, int r) {
          return seen(c, r) && (!ids || kid[c] == qid[r]);
        });
      else
        tile_probs<BN, false>(sc, lane, p, seen);
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * (lane % 4) + (e & 1), r = e >> 1;
          float p = exp2f(fmaf(sc[4 * j + e], c2, -lse2[r]));
          if (masked && !(k0 + c < Tk && visible_pair(qpos[r], k_off + k0 + c, causal, window)))
            p = 0.0f;
          sc[4 * j + e] = p;
        }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dps);
    // dS = P (dP - delta) scale, from the fp32 P.
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dps[4 * j + e] = sc[4 * j + e] * (dps[4 * j + e] - dlt[e >> 1]) * scale;

    // dQ += dS . K, dS rounded to E (K's dtype, as the Pallas kernel), the
    // K tile read MN-major.
    uint32_t da[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) a_frag<E>(da[kk], dps, kk);
    hopper::fence_regs(dq_acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) mma_rs<DT, E>(dq_acc, da[kk], tK, BN, kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq_acc);
    hopper::mbar_arrive(&empty[s]);
  }

  store_acc<DT, E>(dq, sdq, b, h, row0 + wrow0 + 16 * warp + lane / 4, Tq, dq_acc, out_f32,
                   lane, c0, D);
}

// 16-bit dK/dV. One CTA owns BBN keys of one (b, h): the producer warp
// loads K and V once, then streams Q and dO tiles with their rows' lse (in
// log2 units), delta and (SEG) ids through the ring, from the first query
// tile that can see these keys; each consumer warpgroup keeps dK and dV of
// its 64 keys (SPLIT: of half the columns of the CTA's 64) in registers
// over the whole query loop. WIDE: blockIdx.z's chunk of dK and dV, with
// S^T and dP^T over Sm90Wide's slabs (K and V come again with each query
// tile) and the chunk's Q and dO last for each query tile.
template <class E, int DT, bool SEG, bool WIDE>
__global__ void __launch_bounds__(Sm90Cfg<DT>::NT, 1)
    flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap mdo, const float* __restrict__ lse,
                       const float* __restrict__ delta, void* __restrict__ dk,
                       void* __restrict__ dv, const int* __restrict__ q_ids,
                       const int* __restrict__ k_ids, Strides sdk, Strides sdv, int out_f32,
                       int D, int H, int Tq, int Tk, int causal, int q_off, int k_off,
                       int window, float scale) {
  using C = Sm90Cfg<DT>;
  using W = Sm90Wide;
  static_assert(!WIDE || DT == W::CHUNK, "WIDE runs at the 256 tile width");
  constexpr int BN = C::BBN, BQ = C::BBQ, DN = C::DKV_N, SW = W::SW;
  constexpr int ST = WIDE ? W::DKV_ST : C::STAGES;
  constexpr int TILES = WIDE ? ST * W::DKV_STAGE : 2 * C::DKV_KV + 2 * ST * C::DKV_Q;
  // Warpgroup w's keys start at row KW * w of the CTA's tile.
  constexpr int KW = C::SPLIT ? 0 : 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  E* sK = reinterpret_cast<E*>(smem);
  E* sV = reinterpret_cast<E*>(smem + C::DKV_KV);
  E* sQ = reinterpret_cast<E*>(smem + 2 * C::DKV_KV);
  E* sDO = reinterpret_cast<E*>(smem + 2 * C::DKV_KV + ST * C::DKV_Q);
  float* sLse = reinterpret_cast<float*>(smem + TILES);
  float* sDelta = sLse + ST * BQ;
  int* sQid = reinterpret_cast<int*>(sDelta + ST * BQ);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sQid + ST * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;
  [[maybe_unused]] int* sCls = reinterpret_cast<int*>(empty + ST);  // SEG: tile_class

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int key0 = blockIdx.x * BN, k_base = k_off + key0;
  int lo, hi;
  query_tiles(k_base, BN, q_off, BQ, (Tq + BQ - 1) / BQ, causal, window, lo, hi);
  const int wg = threadIdx.x / WG;
  // WIDE: this CTA's columns of dK and dV from c0, and the head dim's slabs.
  const int c0 = WIDE ? blockIdx.z * W::CHUNK : 0, ns = (D + SW - 1) / SW;
  // SEG: q_ids and k_ids are the id tables; a query tile's class.
  const IdTable qtab = id_table(q_ids, gridDim.y / H, Tq);
  const IdTable ktab = id_table(k_ids, gridDim.y / H, Tk);
  [[maybe_unused]] const auto query_class = [&](int qt) {
    return tile_class(tile_ids<BQ>(qtab, b, qt), id_range<1>(ktab, b, key0 / ID_TILE),
                      id_range<1>(ktab, b, (key0 + KW) / ID_TILE));
  };

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
    if constexpr (SEG) {
      if (threadIdx.x / 32 == C::CW * 4) narrow(lo, hi, lane, query_class);
    }
    if (threadIdx.x / 32 != C::CW * 4 || hi == lo) return;
    if (lane == 0) {
      hopper::prefetch_map(&mq);
      hopper::prefetch_map(&mdo);
      if constexpr (!WIDE) {
        hopper::mbar_expect_tx(kv_full, 2 * C::DKV_KV);
        tma_tile<DT>(sK, BN, &mk, kv_full, h, key0, b);
        tma_tile<DT>(sV, BN, &mv, kv_full, h, key0, b);
      }
    }
    [[maybe_unused]] int mine = 0;
    for (int i = 0; i < hi - lo; ++i) {
      const int q0 = (lo + i) * BQ;
      int cls = 0;
      if constexpr (SEG) cls = class_at(i, lo, hi, lane, mine, query_class);
      // WIDE: item n = (ns + 1) i + j of this query tile, slab j of K, V,
      // Q and dO for j < ns; the tile's stage s is its last item's.
      int s = i % ST;
      if constexpr (WIDE) {
        for (int j = 0; j < ns; ++j) {
          const int n = i * (ns + 1) + j, sj = n % ST;
          if (n >= ST) hopper::mbar_wait(&empty[sj], (n / ST - 1) & 1);
          if (lane == 0) {
            E* st = reinterpret_cast<E*>(smem + sj * W::DKV_STAGE);
            if constexpr (SEG) sCls[sj] = cls;
            hopper::mbar_expect_tx(&full[sj], W::DKV_STAGE);
            tma_tile<SW>(st, BN, &mk, &full[sj], h, key0, b, SW * j);
            tma_tile<SW>(st + BN * SW, BN, &mv, &full[sj], h, key0, b, SW * j);
            tma_tile<SW>(st + 2 * BN * SW, BQ, &mq, &full[sj], h, q0, b, SW * j);
            tma_tile<SW>(st + (2 * BN + BQ) * SW, BQ, &mdo, &full[sj], h, q0, b, SW * j);
          } else {
            hopper::mbar_arrive(&full[sj]);
          }
        }
        const int n = i * (ns + 1) + ns;
        s = n % ST;
        if (n >= ST) hopper::mbar_wait(&empty[s], (n / ST - 1) & 1);
      } else {
        if (i >= ST) hopper::mbar_wait(&empty[s], (i / ST - 1) & 1);
      }
      for (int c = lane; c < BQ; c += 32) {
        const int tq = q0 + c;
        const bool in = tq < Tq;
        // A padded row gets lse = +1e30, so exp2(s - lse) is exactly zero.
        sLse[s * BQ + c] = in ? lse[(long long)bh * Tq + tq] * LOG2E : -NEG_INF;
        sDelta[s * BQ + c] = in ? delta[(long long)bh * Tq + tq] : 0.0f;
      }
      if (lane == 0) {
        // SEG: the tile's class, and its padded ids where a consumer
        // warpgroup compares them, by one bulk copy on full[s].
        const bool ids = SEG && compares_ids(cls);
        if constexpr (SEG) sCls[s] = cls;
        hopper::mbar_expect_tx(&full[s], 2 * C::DKV_Q + (ids ? BQ * 4 : 0));
        if constexpr (WIDE) {
          E* st = reinterpret_cast<E*>(smem + s * W::DKV_STAGE);
          tma_tile<W::CHUNK>(st, BQ, &mq, &full[s], h, q0, b, c0);
          tma_tile<W::CHUNK>(st + BQ * W::CHUNK, BQ, &mdo, &full[s], h, q0, b, c0);
        } else {
          tma_tile<DT>(sQ + s * BQ * DT, BQ, &mq, &full[s], h, q0, b);
          tma_tile<DT>(sDO + s * BQ * DT, BQ, &mdo, &full[s], h, q0, b);
        }
        if (ids)
          hopper::bulk_load(sQid + s * BQ, qtab.ids + (long long)b * qtab.pad + q0, BQ * 4,
                            &full[s]);
      } else {
        hopper::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // Consumer warpgroup wg: keys [krow0, krow0 + 64) of the CTA's tile, and
  // of dK and dV the columns [dcol0, dcol0 + DN).
  hopper::regs_inc<232>();
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  if constexpr (SEG) narrow(lo, hi, lane, query_class);  // the producer's range
  const int krow0 = KW * wg, dcol0 = C::SPLIT ? DN * wg : 0;
  const float c2 = scale * LOG2E;
  int kpos[2], kid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tk = key0 + krow0 + 16 * warp + lane / 4 + 8 * r;
    kpos[r] = k_off + tk;
    kid[r] = SEG && tk < Tk ? ktab.ids[(long long)b * ktab.pad + tk] : 0;
  }
  float dk_acc[DN / 2], dv_acc[DN / 2], st[BQ / 2], dpt[BQ / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.0f;

  if constexpr (!WIDE) {
    if (hi > lo) hopper::mbar_wait(kv_full, 0);
  }
  for (int i = 0; i < hi - lo; ++i) {
    const int q0 = (lo + i) * BQ;
    int s, cls = 0;
    const E *tQ, *tDO;
    if constexpr (WIDE) {
      // S^T = K . Q^T and dP^T = V . dO^T slab by slab; then the stage
      // with the chunk's Q and dO (and the tile's rows) is this tile's.
      for (int j = 0; j < ns; ++j) {
        const int n = i * (ns + 1) + j, sj = n % ST;
        const E* sl = reinterpret_cast<const E*>(smem + sj * W::DKV_STAGE);
        hopper::mbar_wait(&full[sj], (n / ST) & 1);
        if (SEG && j == 0) cls = (sCls[sj] >> 2 * wg) & 3;
        if (!(cls & NO_PAIR)) {
          hopper::fence_regs(st);
          hopper::fence_regs(dpt);
          hopper::wgmma_fence();
#pragma unroll
          for (int k = 0; k < SW / 16; ++k)
            hopper::wgmma_ss<BQ, E>(st, kmajor(sl, BN, krow0, k),
                                    kmajor(sl + 2 * BN * SW, BQ, 0, k), j > 0 || k > 0);
          hopper::wgmma_commit();
#pragma unroll
          for (int k = 0; k < SW / 16; ++k)
            hopper::wgmma_ss<BQ, E>(dpt, kmajor(sl + BN * SW, BN, krow0, k),
                                    kmajor(sl + (2 * BN + BQ) * SW, BQ, 0, k), j > 0 || k > 0);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_regs(st);
          hopper::fence_regs(dpt);
        }
        hopper::mbar_arrive(&empty[sj]);
      }
      const int n = i * (ns + 1) + ns;
      s = n % ST;
      tQ = reinterpret_cast<const E*>(smem + s * W::DKV_STAGE);
      tDO = tQ + BQ * W::CHUNK;
      hopper::mbar_wait(&full[s], (n / ST) & 1);
      if (cls & NO_PAIR) {  // no pair of one id in these keys: every P is 0
        hopper::mbar_arrive(&empty[s]);
        continue;
      }
    } else {
      s = i % ST;
      tQ = sQ + s * BQ * DT;
      tDO = sDO + s * BQ * DT;
      hopper::mbar_wait(&full[s], (i / ST) & 1);
      cls = SEG ? (sCls[s] >> 2 * wg) & 3 : 0;
      if (cls & NO_PAIR) {  // no pair of one id in these keys: every P is 0
        hopper::mbar_arrive(&empty[s]);
        continue;
      }

      // S^T = K . Q^T and dP^T = V . dO^T, two groups in flight.
      hopper::fence_regs(st);
      hopper::fence_regs(dpt);
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < DT / 16; ++k)
        hopper::wgmma_ss<BQ, E>(st, kmajor(sK, BN, krow0, k), kmajor(tQ, BQ, 0, k), k > 0);
      hopper::wgmma_commit();
#pragma unroll
      for (int k = 0; k < DT / 16; ++k)
        hopper::wgmma_ss<BQ, E>(dpt, kmajor(sV, BN, krow0, k), kmajor(tDO, BQ, 0, k), k > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_regs(st);
    }
    const float* rLse = sLse + s * BQ;
    const float* rDelta = sDelta + s * BQ;

    // P^T = exp2(S^T c - lse2) under the masks; ids are compared only in a
    // tile that mixes them.
    const bool ids = SEG && cls == 0;
    const bool masked = ids || q0 + BQ > Tq ||
                        !all_visible(q_off + q0, BQ, k_base + krow0, 64, causal, window);
    if constexpr (SEG) {
      const auto p = [&](float x, int c, int) { return exp2f(fmaf(x, c2, -rLse[c])); };
      const auto seen = [&](int c, int r) {
        return q0 + c < Tq && visible_pair(q_off + q0 + c, kpos[r], causal, window);
      };
      const int* qid = sQid + s * BQ;
      if (masked)
        tile_probs<BQ, true>(st, lane, p, [&](int c, int r) {
          return seen(c, r) && (!ids || qid[c] == kid[r]);
        });
      else
        tile_probs<BQ, false>(st, lane, p, seen);
    } else {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * (lane % 4) + (e & 1), r = e >> 1;
          float p = exp2f(fmaf(st[4 * j + e], c2, -rLse[c]));
          if (masked && !(q0 + c < Tq && visible_pair(q_off + q0 + c, kpos[r], causal, window)))
            p = 0.0f;
          st[4 * j + e] = p;
        }
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

    // dV += P^T . dO and dK += dS^T . Q over this warpgroup's columns (the
    // 64-column tiles from dcol0 / 64 on), P and dS rounded to E.
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      a_frag<E>(pa[kk], st, kk);
      a_frag<E>(da[kk], dpt, kk);
    }
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      mma_rs<DN, E>(dv_acc, pa[kk], tDO + dcol0 / 64 * BQ * 64, BQ, kk);
      mma_rs<DN, E>(dk_acc, da[kk], tQ + dcol0 / 64 * BQ * 64, BQ, kk);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::mbar_arrive(&empty[s]);
  }

  const int tk = key0 + krow0 + 16 * warp + lane / 4;
  store_acc<DN, E>(dk, sdk, b, h, tk, Tk, dk_acc, out_f32, lane, c0 + dcol0, D);
  store_acc<DN, E>(dv, sdv, b, h, tk, Tk, dv_acc, out_f32, lane, c0 + dcol0, D);
}

// fp32 forward. Plain mode (lse == m_out == nullptr): o = normalized O in T.
// Train mode (lse set): also lse, +1e30 on rows with no visible key.
// State mode (m_out and l_out set): o is fp32 and receives the
// unnormalized accumulator; m and l are written, no lse. Head dims past DT
// (blockIdx.z a chunk of DT output columns): S runs over the head dim in
// slabs of DT columns, Q and K loaded slab by slab for every key tile,
// then the chunk's V; the chunk that writes_row_stats() picks writes the
// row statistics, which every chunk computes alike.
template <typename T, int DT, bool SEG>
__global__ void __launch_bounds__(Cfg<T, DT>::NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, void* __restrict__ o, float* __restrict__ lse,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     const int* __restrict__ q_ids, const int* __restrict__ k_ids, Strides sq,
                     Strides sk, Strides sv, Strides so, int D, int H, int Tq, int Tk, int causal,
                     int q_off, int k_off, int window, float scale) {
  static_assert(std::is_same<T, float>::value, "16-bit inputs run flash_fwd_sm90");
  using C = Cfg<T, DT>;
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
  // This CTA's output columns [c0, c0 + Dc); the head dim's slabs.
  const int c0 = blockIdx.z * DT, Dc = min(DT, D - c0), nslab = (D + DT - 1) / DT;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  if (nslab == 1) load_tile<T, DT, BM, C::NT>(sQ, C::LDT, qb, sq.t, row0, Tq, D);
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
    if (nslab == 1) {
      load_tile<T, DT, BM, C::NT>(sK, C::LDT, kb, sk.t, kt * BM, Tk, D);
      load_tile<T, DT, BM, C::NT>(sV, C::LDT, vb, sv.t, kt * BM, Tk, D);
      if (SEG) load_ids<BM, C::NT>(sKid, k_ids, b, kt * BM, Tk);
      __syncthreads();
      warp_gemm_nt<T, BM, DT>(sQ + r0 * C::LDT, C::LDT, sK, C::LDT, sS + r0 * C::LDS, C::LDS);
    } else {
      for (int j = 0; j < nslab; ++j) {
        if (j > 0) __syncthreads();  // every warp is done with the last slab
        load_tile<T, DT, BM, C::NT>(sQ, C::LDT, qb + j * DT, sq.t, row0, Tq, D - j * DT);
        load_tile<T, DT, BM, C::NT>(sK, C::LDT, kb + j * DT, sk.t, kt * BM, Tk, D - j * DT);
        __syncthreads();
        warp_gemm_nt<T, BM, DT>(sQ + r0 * C::LDT, C::LDT, sK, C::LDT, sS + r0 * C::LDS, C::LDS,
                                j > 0);
      }
      load_tile<T, DT, BM, C::NT>(sV, C::LDT, vb + c0, sv.t, kt * BM, Tk, D - c0);
      if (SEG) load_ids<BM, C::NT>(sKid, k_ids, b, kt * BM, Tk);
      __syncthreads();
    }
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
      for (int d = half; d < Dc; d += 2) sAcc[r * C::LDF + d] *= corr;
      __syncwarp();
      if (half == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * corr + sum;
      }
    }
    __syncwarp();
    warp_gemm_nn<T, DT, BM>(sP + r0 * C::LDP, C::LDP, sV, C::LDT, sAcc + r0 * C::LDF, C::LDF);
    __syncthreads();
  }

  const bool stats = writes_row_stats();
  for (int i = 0; i < 16; ++i) {
    const int r = r0 + i;
    const int t = row0 + r;
    if (t >= Tq) break;
    const float l = sL[r];
    const long long off = b * so.b + (long long)t * so.t + h * so.h + c0;
    if (m_out != nullptr) {
      float* arow = static_cast<float*>(o) + off;
      for (int d = lane; d < Dc; d += 32) arow[d] = sAcc[r * C::LDF + d];
      if (lane == 0 && stats) {
        m_out[(long long)bh * Tq + t] = sM[r];
        l_out[(long long)bh * Tq + t] = l;
      }
      continue;
    }
    T* orow = static_cast<T*>(o) + off;
    for (int d = lane; d < Dc; d += 32) orow[d] = sAcc[r * C::LDF + d] / fmaxf(l, 1e-30f);
    if (lse != nullptr && lane == 0 && stats)
      lse[(long long)bh * Tq + t] = l > 0.0f ? sM[r] + logf(fmaxf(l, 1e-30f)) : -NEG_INF;
  }
}

// fp32 dQ (16-bit inputs run flash_bwd_dq_sm90). Head dims past DT: S and
// dP over the slabs (Q, dO, K and V slab by slab), then the chunk's K.
template <typename T, int DT, bool SEG>
__global__ void __launch_bounds__(Cfg<T, DT>::NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, const int* __restrict__ q_ids,
                        const int* __restrict__ k_ids, Strides sq, Strides sk, Strides sv,
                        Strides sdo, Strides sdq, int D, int H, int Tq, int Tk, int causal,
                        int q_off, int k_off, int window, float scale) {
  static_assert(std::is_same<T, float>::value, "16-bit inputs run flash_bwd_dq_sm90");
  using C = Cfg<T, DT>;
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
  const int c0 = blockIdx.z * DT, Dc = min(DT, D - c0), nslab = (D + DT - 1) / DT;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  if (nslab == 1) {
    load_tile<T, DT, BM, C::NT>(sQ, C::LDT, qb, sq.t, row0, Tq, D);
    load_tile<T, DT, BM, C::NT>(sDO, C::LDT, dob, sdo.t, row0, Tq, D);
  }
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
    if (nslab == 1) {
      load_tile<T, DT, BM, C::NT>(sK, C::LDT, kb, sk.t, kt * BM, Tk, D);
      load_tile<T, DT, BM, C::NT>(sV, C::LDT, vb, sv.t, kt * BM, Tk, D);
      if (SEG) load_ids<BM, C::NT>(sKid, k_ids, b, kt * BM, Tk);
      __syncthreads();
      warp_gemm_nt<T, BM, DT>(sQ + r0 * C::LDT, C::LDT, sK, C::LDT, sS + r0 * C::LDS, C::LDS);
      warp_gemm_nt<T, BM, DT>(sDO + r0 * C::LDT, C::LDT, sV, C::LDT, sDP + r0 * C::LDS,
                              C::LDS);
    } else {
      for (int j = 0; j < nslab; ++j) {
        if (j > 0) __syncthreads();  // every warp is done with the last slab
        const int rest = D - j * DT;
        load_tile<T, DT, BM, C::NT>(sQ, C::LDT, qb + j * DT, sq.t, row0, Tq, rest);
        load_tile<T, DT, BM, C::NT>(sDO, C::LDT, dob + j * DT, sdo.t, row0, Tq, rest);
        load_tile<T, DT, BM, C::NT>(sK, C::LDT, kb + j * DT, sk.t, kt * BM, Tk, rest);
        load_tile<T, DT, BM, C::NT>(sV, C::LDT, vb + j * DT, sv.t, kt * BM, Tk, rest);
        __syncthreads();
        warp_gemm_nt<T, BM, DT>(sQ + r0 * C::LDT, C::LDT, sK, C::LDT, sS + r0 * C::LDS, C::LDS,
                                j > 0);
        warp_gemm_nt<T, BM, DT>(sDO + r0 * C::LDT, C::LDT, sV, C::LDT, sDP + r0 * C::LDS,
                                C::LDS, j > 0);
      }
      __syncthreads();  // every warp is done with the last slab's K
      load_tile<T, DT, BM, C::NT>(sK, C::LDT, kb + c0, sk.t, kt * BM, Tk, D - c0);
      if (SEG) load_ids<BM, C::NT>(sKid, k_ids, b, kt * BM, Tk);
      __syncthreads();
    }
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
    warp_gemm_nn<T, DT, BM>(sDS, C::LDP, sK, C::LDT, sAcc + r0 * C::LDF, C::LDF);
    __syncthreads();
  }

  for (int i = 0; i < 16; ++i) {
    const int r = r0 + i;
    const int t = row0 + r;
    if (t >= Tq) break;
    store_row(dq + b * sdq.b + (long long)t * sdq.t + h * sdq.h + c0, sAcc + r * C::LDF, lane,
              Dc);
  }
}

// fp32 dK/dV (16-bit inputs run flash_bwd_dkv_sm90). Head dims past DT:
// S^T and dP^T over the slabs (K, V, Q and dO slab by slab), then the
// chunk's Q and dO.
template <typename T, int DT, bool SEG>
__global__ void __launch_bounds__(Cfg<T, DT>::NT)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         const int* __restrict__ q_ids, const int* __restrict__ k_ids,
                         Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                         Strides sdv, int D, int H, int Tq, int Tk, int causal, int q_off,
                         int k_off, int window, float scale) {
  static_assert(std::is_same<T, float>::value, "16-bit inputs run flash_bwd_dkv_sm90");
  using C = Cfg<T, DT>;
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
  const int c0 = blockIdx.z * DT, Dc = min(DT, D - c0), nslab = (D + DT - 1) / DT;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  if (nslab == 1) {
    load_tile<T, DT, BM, C::NT>(sK, C::LDT, kb, sk.t, row0, Tk, D);
    load_tile<T, DT, BM, C::NT>(sV, C::LDT, vb, sv.t, row0, Tk, D);
  }
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
    if (nslab == 1) {
      load_tile<T, DT, BM, C::NT>(sQ, C::LDT, qb, sq.t, qt * BM, Tq, D);
      load_tile<T, DT, BM, C::NT>(sDO, C::LDT, dob, sdo.t, qt * BM, Tq, D);
    } else {
      for (int j = 0; j < nslab; ++j) {
        if (j > 0) __syncthreads();  // every warp is done with the last slab
        const int rest = D - j * DT;
        load_tile<T, DT, BM, C::NT>(sK, C::LDT, kb + j * DT, sk.t, row0, Tk, rest);
        load_tile<T, DT, BM, C::NT>(sV, C::LDT, vb + j * DT, sv.t, row0, Tk, rest);
        load_tile<T, DT, BM, C::NT>(sQ, C::LDT, qb + j * DT, sq.t, qt * BM, Tq, rest);
        load_tile<T, DT, BM, C::NT>(sDO, C::LDT, dob + j * DT, sdo.t, qt * BM, Tq, rest);
        __syncthreads();
        warp_gemm_nt<T, BM, DT>(sK + r0 * C::LDT, C::LDT, sQ, C::LDT, sS + r0 * C::LDS, C::LDS,
                                j > 0);
        warp_gemm_nt<T, BM, DT>(sV + r0 * C::LDT, C::LDT, sDO, C::LDT, sDP + r0 * C::LDS,
                                C::LDS, j > 0);
      }
      __syncthreads();  // every warp is done with the last slab's Q and dO
      load_tile<T, DT, BM, C::NT>(sQ, C::LDT, qb + c0, sq.t, qt * BM, Tq, D - c0);
      load_tile<T, DT, BM, C::NT>(sDO, C::LDT, dob + c0, sdo.t, qt * BM, Tq, D - c0);
    }
    if (SEG) load_ids<BM, C::NT>(sQid, q_ids, b, qt * BM, Tq);
    for (int i = threadIdx.x; i < BM; i += C::NT) {
      const int t = qt * BM + i;
      sLse[i] = t < Tq ? lse[(long long)bh * Tq + t] : -NEG_INF;
      sDelta[i] = t < Tq ? delta[(long long)bh * Tq + t] : 0.0f;
    }
    __syncthreads();

    if (nslab == 1) {
      warp_gemm_nt<T, BM, DT>(sK + r0 * C::LDT, C::LDT, sQ, C::LDT, sS + r0 * C::LDS, C::LDS);
      warp_gemm_nt<T, BM, DT>(sV + r0 * C::LDT, C::LDT, sDO, C::LDT, sDP + r0 * C::LDS,
                              C::LDS);
    }
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
    warp_gemm_nn<T, DT, BM>(sP, C::LDP, sDO, C::LDT, sDV + r0 * C::LDF, C::LDF);
    warp_gemm_nn<T, DT, BM>(sDS, C::LDP, sQ, C::LDT, sDK + r0 * C::LDF, C::LDF);
  }
  __syncthreads();

  for (int i = 0; i < 16; ++i) {
    const int r = r0 + i;
    const int t = row0 + r;
    if (t >= Tk) break;
    store_row(dk + b * sdk.b + (long long)t * sdk.t + h * sdk.h + c0, sDK + r * C::LDF, lane,
              Dc);
    store_row(dv + b * sdv.b + (long long)t * sdv.t + h * sdv.h + c0, sDV + r * C::LDF, lane,
              Dc);
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

// The tensor map of a [B, T, H, D] tensor of E (bf16 or fp16) with element
// strides `s`, read in boxes of `rows` rows by 64 columns (the 128-byte
// swizzle's width), dims (D, H, T, B) innermost first: the q/k/v views of
// the model's fused [B, T, 3, H, D] tensor are read in place. Rows past T
// and columns past D (the true head dim, which a box of a tile wider than D
// crosses or starts past) read as zeros.
template <class E>
int tensor_map(CUtensorMap* map, const void* base, int B, int T, int H, int D, Strides s,
               int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kTensorMapRefused;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)s.h * 2, (cuuint64_t)s.t * 2, (cuuint64_t)s.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type =
      hopper::kF16<E> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = encode(map, type, 4, const_cast<void*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapRefused;
}

// The id tables of both sides of a 16-bit kernel with segment ids, in
// `scratch` (id_table_ints(B, Tq) + id_table_ints(B, Tk) ints): built
// there from q_ids and k_ids when they are given, else read as an earlier
// launch on the same ids built them. Points q_ids and k_ids at them.
int id_tables(int B, int Tq, int Tk, const void*& q_ids, const void*& k_ids, void* scratch,
              cudaStream_t stream) {
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  int* q_tab = static_cast<int*>(scratch);
  int* k_tab = q_tab + id_table_ints(B, Tq);
  if (q_ids != nullptr) {
    if (k_ids == nullptr) return (int)cudaErrorInvalidValue;
    const int tiles = (std::max(Tq, Tk) + ID_ROW - 1) / ID_ROW * (ID_ROW / ID_TILE);
    flash_id_table<<<dim3((tiles + 7) / 8, B, 2), 256, 0, stream>>>(
        (const int*)q_ids, (const int*)k_ids, q_tab, k_tab, B, Tq, Tk);
    if (int err = (int)cudaGetLastError()) return err;
  }
  q_ids = q_tab;
  k_ids = k_tab;
  return 0;
}

// Chunks of DT output columns at head dim D (grid z): 1 for D <= DT.
inline int chunks(int D, int DT) { return (D + DT - 1) / DT; }

template <class E, int DT, bool WIDE>
int launch_fwd_sm90(int D, int B, int H, int Tq, int Tk, const void* q, const void* k,
                    const void* v, void* o, void* lse, void* m, void* l, const void* q_ids,
                    const void* k_ids, void* id_scratch, const long long* s, int causal, int q_off,
                    int k_off, int window, float scale, cudaStream_t stream) {
  using C = Sm90Cfg<DT>;
  constexpr int SMEM = WIDE ? Sm90Wide::FWD_SMEM : C::FWD_SMEM;
  constexpr auto seg = flash_fwd_sm90<E, DT, true, WIDE>;
  constexpr auto plain = flash_fwd_sm90<E, DT, false, WIDE>;
  const bool ids = q_ids || id_scratch;
  if (int err = ids ? prepare<seg>(SMEM) : prepare<plain>(SMEM)) return err;
  if (ids)
    if (int err = id_tables(B, Tq, Tk, q_ids, k_ids, id_scratch, stream)) return err;
  CUtensorMap mq, mk, mv;
  if (int err = tensor_map<E>(&mq, q, B, Tq, H, D, strides_at(s, 0), C::FBM)) return err;
  if (int err = tensor_map<E>(&mk, k, B, Tk, H, D, strides_at(s, 1), C::FBN)) return err;
  if (int err = tensor_map<E>(&mv, v, B, Tk, H, D, strides_at(s, 2), C::FBN)) return err;
  dim3 grid((Tq + C::FBM - 1) / C::FBM, B * H, chunks(D, DT));
  (ids ? seg : plain)<<<grid, C::NT, SMEM, stream>>>(
      mq, mk, mv, o, (float*)lse, (float*)m, (float*)l, (const int*)q_ids, (const int*)k_ids,
      strides_at(s, 3), D, H, Tq, Tk, causal, q_off, k_off, window, scale);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_fwd_f32(int D, int B, int H, int Tq, int Tk, const void* q, const void* k,
                   const void* v, void* o, void* lse, void* m, void* l, const void* q_ids,
                   const void* k_ids, void*, const long long* s, int causal, int q_off, int k_off,
                   int window, float scale, cudaStream_t stream) {
  using C = Cfg<float, DT>;
  constexpr auto seg = flash_fwd_kernel<float, DT, true>;
  constexpr auto plain = flash_fwd_kernel<float, DT, false>;
  if (int err = q_ids ? prepare<seg>(C::FWD_SMEM) : prepare<plain>(C::FWD_SMEM)) return err;
  dim3 grid((Tq + C::BM - 1) / C::BM, B * H, chunks(D, DT));
  (q_ids ? seg : plain)<<<grid, C::NT, C::FWD_SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, o, (float*)lse, (float*)m, (float*)l,
      (const int*)q_ids, (const int*)k_ids, strides_at(s, 0), strides_at(s, 1), strides_at(s, 2),
      strides_at(s, 3), D, H, Tq, Tk, causal, q_off, k_off, window, scale);
  return (int)cudaGetLastError();
}

template <class E, int DT, bool WIDE>
int launch_dq_sm90(int D, int B, int H, int Tq, int Tk, const void* q, const void* k,
                   const void* v, const void* dout, const void* lse, const void* delta, void* dq,
                   const void* q_ids, const void* k_ids, void* id_scratch, const long long* s,
                   int out_f32, int causal, int q_off, int k_off, int window, float scale,
                   cudaStream_t stream) {
  using C = Sm90Cfg<DT>;
  constexpr int SMEM = WIDE ? Sm90Wide::DQ_SMEM : C::DQ_SMEM;
  constexpr auto seg = flash_bwd_dq_sm90<E, DT, true, WIDE>;
  constexpr auto plain = flash_bwd_dq_sm90<E, DT, false, WIDE>;
  const bool ids = q_ids || id_scratch;
  if (int err = ids ? prepare<seg>(SMEM) : prepare<plain>(SMEM)) return err;
  if (ids)
    if (int err = id_tables(B, Tq, Tk, q_ids, k_ids, id_scratch, stream)) return err;
  CUtensorMap mq, mk, mv, mdo;
  if (int err = tensor_map<E>(&mq, q, B, Tq, H, D, strides_at(s, 0), C::QBM)) return err;
  if (int err = tensor_map<E>(&mk, k, B, Tk, H, D, strides_at(s, 1), C::QBN)) return err;
  if (int err = tensor_map<E>(&mv, v, B, Tk, H, D, strides_at(s, 2), C::QBN)) return err;
  if (int err = tensor_map<E>(&mdo, dout, B, Tq, H, D, strides_at(s, 3), C::QBM)) return err;
  dim3 grid((Tq + C::QBM - 1) / C::QBM, B * H, chunks(D, DT));
  (ids ? seg : plain)<<<grid, C::NT, SMEM, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)delta, dq, (const int*)q_ids,
      (const int*)k_ids, strides_at(s, 4), out_f32, D, H, Tq, Tk, causal, q_off, k_off, window,
      scale);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_dq_f32(int D, int B, int H, int Tq, int Tk, const void* q, const void* k,
                  const void* v, const void* dout, const void* lse, const void* delta, void* dq,
                  const void* q_ids, const void* k_ids, void*, const long long* s, int,
                  int causal, int q_off, int k_off, int window, float scale,
                  cudaStream_t stream) {
  using C = Cfg<float, DT>;
  constexpr auto seg = flash_bwd_dq_kernel<float, DT, true>;
  constexpr auto plain = flash_bwd_dq_kernel<float, DT, false>;
  if (int err = q_ids ? prepare<seg>(C::DQ_SMEM) : prepare<plain>(C::DQ_SMEM)) return err;
  dim3 grid((Tq + C::BM - 1) / C::BM, B * H, chunks(D, DT));
  (q_ids ? seg : plain)<<<grid, C::NT, C::DQ_SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (float*)dq, (const int*)q_ids, (const int*)k_ids, strides_at(s, 0),
      strides_at(s, 1), strides_at(s, 2), strides_at(s, 3), strides_at(s, 4), D, H, Tq, Tk,
      causal, q_off, k_off, window, scale);
  return (int)cudaGetLastError();
}

template <class E, int DT, bool WIDE>
int launch_dkv_sm90(int D, int B, int H, int Tq, int Tk, const void* q, const void* k,
                    const void* v, const void* dout, const void* lse, const void* delta, void* dk,
                    void* dv, const void* q_ids, const void* k_ids, void* id_scratch,
                    const long long* s, int out_f32, int causal, int q_off, int k_off, int window,
                    float scale, cudaStream_t stream) {
  using C = Sm90Cfg<DT>;
  constexpr int SMEM = WIDE ? Sm90Wide::DKV_SMEM : C::DKV_SMEM;
  constexpr auto seg = flash_bwd_dkv_sm90<E, DT, true, WIDE>;
  constexpr auto plain = flash_bwd_dkv_sm90<E, DT, false, WIDE>;
  const bool ids = q_ids || id_scratch;
  if (int err = ids ? prepare<seg>(SMEM) : prepare<plain>(SMEM)) return err;
  if (ids)
    if (int err = id_tables(B, Tq, Tk, q_ids, k_ids, id_scratch, stream)) return err;
  CUtensorMap mq, mk, mv, mdo;
  if (int err = tensor_map<E>(&mq, q, B, Tq, H, D, strides_at(s, 0), C::BBQ)) return err;
  if (int err = tensor_map<E>(&mk, k, B, Tk, H, D, strides_at(s, 1), C::BBN)) return err;
  if (int err = tensor_map<E>(&mv, v, B, Tk, H, D, strides_at(s, 2), C::BBN)) return err;
  if (int err = tensor_map<E>(&mdo, dout, B, Tq, H, D, strides_at(s, 3), C::BBQ)) return err;
  dim3 grid((Tk + C::BBN - 1) / C::BBN, B * H, chunks(D, DT));
  (ids ? seg : plain)<<<grid, C::NT, SMEM, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)delta, dk, dv, (const int*)q_ids,
      (const int*)k_ids, strides_at(s, 4), strides_at(s, 5), out_f32, D, H, Tq, Tk, causal,
      q_off, k_off, window, scale);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_dkv_f32(int D, int B, int H, int Tq, int Tk, const void* q, const void* k,
                   const void* v, const void* dout, const void* lse, const void* delta, void* dk,
                   void* dv, const void* q_ids, const void* k_ids, void*, const long long* s, int,
                   int causal, int q_off, int k_off, int window, float scale,
                   cudaStream_t stream) {
  using C = Cfg<float, DT>;
  constexpr auto seg = flash_bwd_dkv_kernel<float, DT, true>;
  constexpr auto plain = flash_bwd_dkv_kernel<float, DT, false>;
  if (int err = q_ids ? prepare<seg>(C::DKV_SMEM) : prepare<plain>(C::DKV_SMEM)) return err;
  dim3 grid((Tk + C::BM - 1) / C::BM, B * H, chunks(D, DT));
  (q_ids ? seg : plain)<<<grid, C::NT, C::DKV_SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (float*)dk, (float*)dv, (const int*)q_ids, (const int*)k_ids,
      strides_at(s, 0), strides_at(s, 1), strides_at(s, 2), strides_at(s, 3), strides_at(s, 4),
      strides_at(s, 5), D, H, Tq, Tk, causal, q_off, k_off, window, scale);
  return (int)cudaGetLastError();
}

// Element size in bytes of each dtype code: 0 fp32, 1 bf16, 2 fp16.
constexpr int elem_bytes(int dtype) { return dtype == 0 ? 4 : 2; }

// The tile width the kernels run head dim D at: the smallest of 64, 128
// and 256 that holds it, and 256 for every D past it (in chunks of 256
// output columns); 0 for a D they do not take: below 1, or a row that is
// not whole 16-byte words (16-bit D % 8, fp32 D % 4; the wrapper pads
// such a D), or an unknown dtype.
int tile_dim(int dtype, int D) {
  if (dtype < 0 || dtype > 2 || D < 1 || D * elem_bytes(dtype) % 16) return 0;
  return D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

}  // namespace

// The argument lists of the three launchers, shared by the dtype parts.
#define HVD_FWD_PARAMS                                                                      \
  int D, int B, int H, int Tq, int Tk, const void *q, const void *k, const void *v, void *o, \
      void *lse, void *m, void *l, const void *q_ids, const void *k_ids, void *id_scratch,    \
      const long long *s, int causal, int q_off, int k_off, int window, float scale,          \
      cudaStream_t stream
#define HVD_FWD_ARGS                                                                      \
  D, B, H, Tq, Tk, q, k, v, o, lse, m, l, q_ids, k_ids, id_scratch, s, causal, q_off, k_off, \
      window, scale, stream
#define HVD_DQ_PARAMS                                                                      \
  int D, int B, int H, int Tq, int Tk, const void *q, const void *k, const void *v,         \
      const void *dout, const void *lse, const void *delta, void *dq, const void *q_ids,    \
      const void *k_ids, void *id_scratch, const long long *s, int out_f32, int causal,      \
      int q_off, int k_off, int window, float scale, cudaStream_t stream
#define HVD_DQ_ARGS                                                                       \
  D, B, H, Tq, Tk, q, k, v, dout, lse, delta, dq, q_ids, k_ids, id_scratch, s, out_f32,    \
      causal, q_off, k_off, window, scale, stream
#define HVD_DKV_PARAMS                                                                     \
  int D, int B, int H, int Tq, int Tk, const void *q, const void *k, const void *v,         \
      const void *dout, const void *lse, const void *delta, void *dk, void *dv,             \
      const void *q_ids, const void *k_ids, void *id_scratch, const long long *s,           \
      int out_f32, int causal, int q_off, int k_off, int window, float scale,               \
      cudaStream_t stream
#define HVD_DKV_ARGS                                                                      \
  D, B, H, Tq, Tk, q, k, v, dout, lse, delta, dk, dv, q_ids, k_ids, id_scratch, s, out_f32, \
      causal, q_off, k_off, window, scale, stream

// The source builds as three translation units that the library links
// (HVD_PART, ops/_build.py compiles them in parallel): 0 the fp32 kernels
// and the C interface, 1 the bf16 kernels, 2 the fp16 kernels.
// Each 16-bit part defines its dtype's entry points, which dispatch on the
// tile width: 64, 128, 256, and past 256 the WIDE kernels.
namespace hvd_flash_parts {
int fwd_bf16(HVD_FWD_PARAMS);
int fwd_f16(HVD_FWD_PARAMS);
int dq_bf16(HVD_DQ_PARAMS);
int dq_f16(HVD_DQ_PARAMS);
int dkv_bf16(HVD_DKV_PARAMS);
int dkv_f16(HVD_DKV_PARAMS);
}  // namespace hvd_flash_parts

#define HVD_DISPATCH16(E, launcher, ...)                            \
  switch (tile_dim(1, D) + (D > 256)) {                            \
    case 64: return launcher<E, 64, false>(__VA_ARGS__);           \
    case 128: return launcher<E, 128, false>(__VA_ARGS__);         \
    case 256: return launcher<E, 256, false>(__VA_ARGS__);         \
    case 257: return launcher<E, 256, true>(__VA_ARGS__);          \
    default: return kUnsupported;                                  \
  }

#define HVD_PART16(E, suffix)                                                                   \
  int hvd_flash_parts::fwd_##suffix(HVD_FWD_PARAMS) {                                           \
    HVD_DISPATCH16(E, launch_fwd_sm90, HVD_FWD_ARGS)                                            \
  }                                                                                             \
  int hvd_flash_parts::dq_##suffix(HVD_DQ_PARAMS) {                                             \
    HVD_DISPATCH16(E, launch_dq_sm90, HVD_DQ_ARGS)                                              \
  }                                                                                             \
  int hvd_flash_parts::dkv_##suffix(HVD_DKV_PARAMS) {                                           \
    HVD_DISPATCH16(E, launch_dkv_sm90, HVD_DKV_ARGS)                                            \
  }

#if HVD_PART == 1
HVD_PART16(bf16, bf16)
#endif
#if HVD_PART == 2
HVD_PART16(f16, f16)
#endif

#if HVD_PART == 0

// One launcher of each dtype: fp32 by the tile width here, bf16 and fp16
// in their parts.
#define HVD_DISPATCH(part, f32_launcher, ...)                           \
  switch (dtype * 1000 + tile_dim(dtype, D)) {                         \
    case 64: return f32_launcher<64>(__VA_ARGS__);                     \
    case 128: return f32_launcher<128>(__VA_ARGS__);                   \
    case 256: return f32_launcher<256>(__VA_ARGS__);                   \
    case 1064: case 1128: case 1256:                                   \
      return hvd_flash_parts::part##_bf16(__VA_ARGS__);                \
    case 2064: case 2128: case 2256:                                   \
      return hvd_flash_parts::part##_f16(__VA_ARGS__);                 \
    default: return kUnsupported;                                      \
  }

// C interface, bound with ctypes (horovod_tpu_torch/ops/_build.py).
// dtype: 0 = fp32, 1 = bf16, 2 = fp16. D: the head dim (any D >= 1 whose
// row is whole 16-byte words: a multiple of 8 in bf16 and fp16, of 4 in
// fp32; past 256 the grid's z dim runs chunks of 256 output columns).
// `strides` holds (b, t, h) element strides of each tensor argument in
// order. Forward modes: lse set = train; m and l set = state (o is fp32);
// out_f32: the backward kernels write fp32 outputs.
// Segment ids: q_ids/k_ids are int32 [B, Tq] and [B, Tk], and id_scratch
// the id tables of 16-bit inputs (id_table_ints(B, Tq) + id_table_ints(B,
// Tk) int32 values, 16-byte aligned):
//   q_ids, k_ids and id_scratch null: no segment ids;
//   q_ids and k_ids set: fp32 reads them as given; 16-bit inputs first
//     build the tables from them into id_scratch, which must be set;
//   q_ids and k_ids null, id_scratch set (16-bit only): the tables are
//     already in id_scratch, built by an earlier call on the same ids and
//     shapes (one call's forward builds them, its backward kernels read).
// Returns 0 or the cudaError_t of the launch (-1 for an unsupported
// dtype/D pair, -2 for a refused tensor map).
extern "C" {

const char* hvd_error_string(int err) {
  if (err == kTensorMapRefused)
    return "cuTensorMapEncodeTiled refused a tensor map (pointer or strides not 16-byte aligned, "
           "or no driver entry point)";
  return cudaGetErrorString((cudaError_t)err);
}

int hvd_flash_fwd(int dtype, int D, int B, int H, int Tq, int Tk, const void* q,
                  const void* k, const void* v, void* o, void* lse, void* m, void* l,
                  const void* q_ids, const void* k_ids, void* id_scratch,
                  const long long* strides, int causal, int q_off, int k_off, int window,
                  float scale, void* stream) {
  const long long* s = strides;
  HVD_DISPATCH(fwd, launch_fwd_f32, D, B, H, Tq, Tk, q, k, v, o, lse, m, l, q_ids, k_ids,
               id_scratch, s, causal, q_off, k_off, window, scale,
               (cudaStream_t)stream);
}

// Keys per tile of the forward kernel at head dim D (P is rounded to the
// inputs' dtype against the running max of each such tile), or -1 for an
// unsupported pair.
int hvd_flash_fwd_key_tile(int dtype, int D) {
  switch (dtype * 1000 + tile_dim(dtype, D)) {
    case 1064: case 2064: return Sm90Cfg<64>::FBN;
    case 1128: case 2128: return Sm90Cfg<128>::FBN;
    case 1256: case 2256: return Sm90Cfg<256>::FBN;
    case 64: return Cfg<float, 64>::BM;
    case 128: return Cfg<float, 128>::BM;
    case 256: return Cfg<float, 256>::BM;
    default: return kUnsupported;
  }
}

int hvd_flash_bwd_dq(int dtype, int D, int B, int H, int Tq, int Tk, const void* q,
                     const void* k, const void* v, const void* dout, const void* lse,
                     const void* delta, void* dq, const void* q_ids, const void* k_ids,
                     void* id_scratch, const long long* strides, int out_f32, int causal,
                     int q_off, int k_off, int window, float scale, void* stream) {
  const long long* s = strides;
  HVD_DISPATCH(dq, launch_dq_f32, D, B, H, Tq, Tk, q, k, v, dout, lse, delta, dq, q_ids, k_ids,
               id_scratch, s, out_f32, causal, q_off, k_off, window, scale,
               (cudaStream_t)stream);
}

int hvd_flash_bwd_dkv(int dtype, int D, int B, int H, int Tq, int Tk, const void* q,
                      const void* k, const void* v, const void* dout, const void* lse,
                      const void* delta, void* dk, void* dv, const void* q_ids,
                      const void* k_ids, void* id_scratch, const long long* strides,
                      int out_f32, int causal, int q_off, int k_off, int window, float scale,
                      void* stream) {
  const long long* s = strides;
  HVD_DISPATCH(dkv, launch_dkv_f32, D, B, H, Tq, Tk, q, k, v, dout, lse, delta, dk, dv, q_ids,
               k_ids, id_scratch, s, out_f32, causal, q_off, k_off, window, scale,
               (cudaStream_t)stream);
}

}  // extern "C"

#endif
