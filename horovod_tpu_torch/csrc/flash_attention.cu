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
// is contiguous; b/t/h strides are arbitrary multiples of 16 bytes), so no
// [B*H, T, D] copy is made. lse, delta, m and l are fp32 [B, H, Tq]
// contiguous; segment ids are int32 [B, Tq] and [B, Tk] contiguous, one
// row per batch entry (no per-head copy). Outputs are written through
// their own strides.
//
// Design. One CTA owns one 64-row tile (32 rows for fp32 at D=128, to fit
// shared memory) of the parallel dimension and loops over the tiles of the
// other dimension inside the block: the TPU grid's sequential axis becomes
// that loop, so the dK/dV pass needs no atomics, like the Pallas kernel.
// Each warp owns a 16-row strip of every per-tile matrix, so after the
// block-wide tile loads only warp-level syncs are needed. Matrix products
// run on the tensor cores through WMMA (bf16 x bf16 -> fp32, m16n16k16);
// fp32 inputs use an FMA loop so fp32 stays fp32 (no TF32 rounding). The
// online-softmax state (m, l) and the fp32 accumulators live in shared
// memory. Causal and sliding-window tiles that hold no visible key are
// culled before they are loaded; segment ids mask pairs inside a tile and
// never cull one. Segment ids are a template flag (SEG): the launcher picks
// the instantiation by whether ids were given, so a call without them runs
// code with no id loads or compares (a runtime test in the inner loops
// cost 10-25 % at the slice's shape, PERF.md). A ragged last tile is zero-filled and masked inside the
// kernel, so every T is served. In state mode a block whose every tile is
// culled (a future block of the ring) still writes m = -1e30, l = 0 and
// acc = 0 for every row, the state the ring merge expects.
//
// Bound at the slice's shape (B=8, T=1024, H=12, D=64, causal, bf16, one
// layer): the forward needs ~12.9 GFLOP (QK^T and PV over the visible
// pairs) and moves ~50 MB, so on an H100 (989 TFLOP/s bf16, 3.35 TB/s) it
// is bound by bytes (~15 us) rather than operations (~13 us); dQ needs
// 3/2 and dK/dV 2x the forward's operations over ~63 MB and ~76 MB. The
// ring's past block (Tq = Tk = 2048, all pairs visible) is bound by
// operations: ~103 GFLOP (~104 us) against ~125 MB (~38 us). This version
// is simple rather than fast: WMMA through shared memory, no TMA/wgmma
// pipeline and no warp specialisation (PERF.md has its time).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, t, h;  // element strides of a [B, T, H, D] tensor
};

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// One output row of D values from a fp32 shared row, in the input dtype T
// or (out_f32) in fp32.
template <typename T, int D>
__device__ __forceinline__ void store_row(void* base, long long off, const float* src,
                                          bool out_f32, int lane) {
  if (out_f32) {
    float* row = static_cast<float*>(base) + off;
    for (int d = lane; d < D; d += 32) row[d] = src[d];
  } else {
    T* row = static_cast<T*>(base) + off;
    for (int d = lane; d < D; d += 32) row[d] = from_f<T>(src[d]);
  }
}

__host__ __device__ constexpr int align128(int x) { return (x + 127) & ~127; }

// Tile geometry. BM rows per tile (of Q and of K alike); one warp per
// 16-row strip. Leading dimensions are padded against bank conflicts and
// keep every WMMA pointer 32-byte aligned.
template <typename T, int D>
struct Cfg {
  static constexpr int ES = (int)sizeof(T);
  static constexpr int BM = (ES == 4 && D == 128) ? 32 : 64;
  static constexpr int NW = BM / 16;
  static constexpr int NT = NW * 32;
  static constexpr int LDT = D + (ES == 2 ? 8 : 4);   // [BM][D] tiles of T
  static constexpr int LDF = D + 4;                   // [BM][D] fp32 accumulators
  static constexpr int LDS = BM + 4;                  // [BM][BM] fp32 scores
  static constexpr int LDP = BM + (ES == 2 ? 8 : 4);  // [BM][BM] tiles of T
  static constexpr int TILE = align128(BM * LDT * ES);
  static constexpr int ACC = align128(BM * LDF * 4);
  static constexpr int SCORE = align128(BM * LDS * 4);
  static constexpr int PROB = align128(BM * LDP * ES);
  static constexpr int ROW = align128(BM * 4);  // BM floats or int32 ids
  // Four row vectors each: two of fp32 row statistics, two of segment ids.
  static constexpr int FWD_SMEM = 3 * TILE + SCORE + PROB + ACC + 4 * ROW;
  // The backward kernels write P and dS (in T) over their warp's strip of
  // the fp32 S and dP tiles once read: dK/dV then fits two CTAs per SM.
  static constexpr int DQ_SMEM = 4 * TILE + 2 * SCORE + ACC + 4 * ROW;
  static constexpr int DKV_SMEM = 4 * TILE + 2 * SCORE + 2 * ACC + 4 * ROW;
};

// C[16][N] = A[16][K] . B[N][K]^T for this warp's strip.
template <typename T, int N, int K>
__device__ __forceinline__ void warp_gemm_nt(const T* A, int lda, const T* B, int ldb,
                                             float* C, int ldc) {
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, A + k0, lda);
        wmma::load_matrix_sync(b, B + n0 * ldb + k0, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + n0, c, ldc, wmma::mem_row_major);
    }
  } else {
    const int lane = threadIdx.x & 31;
    for (int idx = lane; idx < 16 * N; idx += 32) {
      const int i = idx / N, n = idx % N;
      float acc = 0.0f;
      for (int k = 0; k < K; ++k) acc = fmaf(A[i * lda + k], B[n * ldb + k], acc);
      C[i * ldc + n] = acc;
    }
  }
  __syncwarp();
}

// C[16][N] += A[16][K] . B[K][N] for this warp's strip.
template <typename T, int N, int K>
__device__ __forceinline__ void warp_gemm_nn(const T* A, int lda, const T* B, int ldb,
                                             float* C, int ldc) {
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
#pragma unroll
    for (int n0 = 0; n0 < N; n0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, C + n0, ldc, wmma::mem_row_major);
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, A + k0, lda);
        wmma::load_matrix_sync(b, B + k0 * ldb + n0, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + n0, c, ldc, wmma::mem_row_major);
    }
  } else {
    const int lane = threadIdx.x & 31;
    for (int idx = lane; idx < 16 * N; idx += 32) {
      const int i = idx / N, n = idx % N;
      float acc = C[i * ldc + n];
      for (int k = 0; k < K; ++k) acc = fmaf(A[i * lda + k], B[k * ldb + n], acc);
      C[i * ldc + n] = acc;
    }
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

// Forward. Plain mode (lse == m_out == nullptr): o = normalized O in T.
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
        sP[r * C::LDP + 2 * j + half] = from_f<T>(p);  // P in V's dtype, as Pallas
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
    for (int d = lane; d < D; d += 32) orow[d] = from_f<T>(sAcc[r * C::LDF + d] / fmaxf(l, 1e-30f));
    if (lse != nullptr && lane == 0)
      lse[(long long)bh * Tq + t] = l > 0.0f ? sM[r] + logf(fmaxf(l, 1e-30f)) : -NEG_INF;
  }
}

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(Cfg<T, D>::NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        void* __restrict__ dq, const int* __restrict__ q_ids,
                        const int* __restrict__ k_ids, Strides sq, Strides sk, Strides sv,
                        Strides sdo, Strides sdq, int out_f32, int H, int Tq, int Tk,
                        int causal, int q_off, int k_off, int window, float scale) {
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
      for (int j = 0; j < BM / 32; ++j) sDS[i * C::LDP + lane + 32 * j] = from_f<T>(ds[i][j]);
    __syncwarp();
    warp_gemm_nn<T, D, BM>(sDS, C::LDP, sK, C::LDT, sAcc + r0 * C::LDF, C::LDF);
    __syncthreads();
  }

  for (int i = 0; i < 16; ++i) {
    const int r = r0 + i;
    const int t = row0 + r;
    if (t >= Tq) break;
    store_row<T, D>(dq, b * sdq.b + (long long)t * sdq.t + h * sdq.h, sAcc + r * C::LDF,
                    out_f32, lane);
  }
}

template <typename T, int D, bool SEG>
__global__ void __launch_bounds__(Cfg<T, D>::NT)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         void* __restrict__ dk, void* __restrict__ dv,
                         const int* __restrict__ q_ids, const int* __restrict__ k_ids,
                         Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                         Strides sdv, int out_f32, int H, int Tq, int Tk, int causal,
                         int q_off, int k_off, int window, float scale) {
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
        sP[i * C::LDP + lane + 32 * j] = from_f<T>(p[i][j]);
        sDS[i * C::LDP + lane + 32 * j] = from_f<T>(ds[i][j]);
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
    store_row<T, D>(dk, b * sdk.b + (long long)t * sdk.t + h * sdk.h, sDK + r * C::LDF,
                    out_f32, lane);
    store_row<T, D>(dv, b * sdv.b + (long long)t * sdv.t + h * sdv.h, sDV + r * C::LDF,
                    out_f32, lane);
  }
}

Strides strides_at(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

template <typename Kernel>
int prepare(Kernel kernel, int smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, int D>
int launch_fwd(int B, int H, int Tq, int Tk, const void* q, const void* k, const void* v,
               void* o, void* lse, void* m, void* l, const void* q_ids, const void* k_ids,
               const long long* s, int causal, int q_off, int k_off, int window, float scale,
               cudaStream_t stream) {
  using C = Cfg<T, D>;
  auto kernel = q_ids ? flash_fwd_kernel<T, D, true> : flash_fwd_kernel<T, D, false>;
  if (int err = prepare(kernel, C::FWD_SMEM)) return err;
  dim3 grid((Tq + C::BM - 1) / C::BM, B * H);
  kernel<<<grid, C::NT, C::FWD_SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, o, (float*)lse, (float*)m, (float*)l,
      (const int*)q_ids, (const int*)k_ids, strides_at(s, 0), strides_at(s, 1),
      strides_at(s, 2), strides_at(s, 3), H, Tq, Tk, causal, q_off, k_off, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(int B, int H, int Tq, int Tk, const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* delta, void* dq,
              const void* q_ids, const void* k_ids, const long long* s, int out_f32,
              int causal, int q_off, int k_off, int window, float scale, cudaStream_t stream) {
  using C = Cfg<T, D>;
  auto kernel = q_ids ? flash_bwd_dq_kernel<T, D, true> : flash_bwd_dq_kernel<T, D, false>;
  if (int err = prepare(kernel, C::DQ_SMEM)) return err;
  dim3 grid((Tq + C::BM - 1) / C::BM, B * H);
  kernel<<<grid, C::NT, C::DQ_SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, dq, (const int*)q_ids, (const int*)k_ids, strides_at(s, 0),
      strides_at(s, 1), strides_at(s, 2), strides_at(s, 3), strides_at(s, 4), out_f32, H, Tq,
      Tk, causal, q_off, k_off, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(int B, int H, int Tq, int Tk, const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta, void* dk, void* dv,
               const void* q_ids, const void* k_ids, const long long* s, int out_f32,
               int causal, int q_off, int k_off, int window, float scale,
               cudaStream_t stream) {
  using C = Cfg<T, D>;
  auto kernel = q_ids ? flash_bwd_dkv_kernel<T, D, true> : flash_bwd_dkv_kernel<T, D, false>;
  if (int err = prepare(kernel, C::DKV_SMEM)) return err;
  dim3 grid((Tk + C::BM - 1) / C::BM, B * H);
  kernel<<<grid, C::NT, C::DKV_SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, dk, dv, (const int*)q_ids, (const int*)k_ids, strides_at(s, 0),
      strides_at(s, 1), strides_at(s, 2), strides_at(s, 3), strides_at(s, 4),
      strides_at(s, 5), out_f32, H, Tq, Tk, causal, q_off, k_off, window, scale);
  return (int)cudaGetLastError();
}

constexpr int kUnsupported = -1;

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
// launch (-1 for an unsupported dtype/D pair).
extern "C" {

const char* hvd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int hvd_flash_fwd(int dtype, int D, int B, int H, int Tq, int Tk, const void* q,
                  const void* k, const void* v, void* o, void* lse, void* m, void* l,
                  const void* q_ids, const void* k_ids, const long long* strides, int causal,
                  int q_off, int k_off, int window, float scale, void* stream) {
  HVD_DISPATCH(launch_fwd, B, H, Tq, Tk, q, k, v, o, lse, m, l, q_ids, k_ids, strides, causal,
               q_off, k_off, window, scale, (cudaStream_t)stream);
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
