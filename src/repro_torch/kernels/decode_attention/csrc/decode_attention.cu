// Flash-decode for Hopper (sm_90a): one decode token of GQA attention per
// sequence, over a block-paged K/V store or over contiguous slot caches.
//
// Replaces the TPU kernels `paged_decode_attention_grouped` /
// `_paged_decode_kernel` (src/repro/kernels/decode_attention/kernel.py:147,
// body :108) and `decode_attention_grouped` / `_decode_kernel` (same file,
// :74, body :37).  It computes what those kernels compute, not how: the TPU
// walks the cache blocks as the sequential third grid axis with the
// online-softmax state in VMEM scratch; here the sequence is split across
// the blocks of a thread-block cluster and across the warps of each block,
// and the partial softmax states are combined at the end.  The two variants
// share one body and differ only in where row `pos` of sequence b lives
// (the `Rows` template argument):
//   * PagedRows: the lane that stages a row reads table[b, pos / block_size]
//     itself (the TPU scalar-prefetches it) to find the physical block; a
//     row is D contiguous elements, rows are Hkv * D apart;
//   * ContiguousRows: caches [B, S, Hkv, D]; row (b, pos) is plain
//     arithmetic.  No block table is built for this case.
//
// Semantics (held against ref.decode_ref / ref.paged_decode_ref): scores in
// float32 with scale 1/sqrt(D); positions >= len are never read (the
// reference masks them with -1e30, whose exp underflows to exactly 0, so
// skipping them adds the same zeros); positions past the cache (S, or
// max_blocks * block_size) do not exist, so a length beyond the cache
// attends every position -- what the reference does when a full slot's
// length keeps growing; the output is acc / max(l, 1e-30), so a length of
// 0 gives 0.  The contiguous entry point can also write each query head's
// log-sum-exp (mx + log l, -inf at length 0): a rank holding one sequence
// shard of a cache under a device mesh returns it beside its output, and
// the ranks' outputs combine as the blocks of a cluster do below.
// The arithmetic depends only on logical positions and on the split, which
// the host picks from shapes alone, so relocating physical blocks changes
// no bit and two calls on the same inputs agree bit for bit.
//
// Bound: the kernel is bytes-bound.  Per layer call it must read
// sum_b min(len_b, S) * Hkv * D * 2 (K and V) * itemsize bytes, at 3.35 TB/s
// on an H100 SXM, and does about 4 * G flops per K/V element (G = 3 for
// llama3.2-3b, 1 for zamba2-2.7b), far below the card's compute rate.  At
// the llama3.2-3b decode shape (B 8, Hkv 8, D 128, lengths ~512, bf16) that
// is 16.8 MB, 0.005 ms; the earlier body (one block per (sequence, kv head),
// 64 blocks on 132 SMs, each tile loaded and then computed, four block
// barriers a tile) took ~0.114 ms of device time there.
//
// Design (each step measured on the card; PERF.md):
// * Split, with no host work beyond picking two numbers: a cluster of
//   `splits` blocks (1, 2, 4 or 8) owns one (sequence b, kv head h), and a
//   block has 4 or 8 warps (`choose_shape`: the grid is kept within one
//   wave of the SMs, from B * Hkv and the cache's capacity; the lengths
//   stay on the device).  Each block reads lens[b] and takes an even,
//   tile-aligned share of the valid tiles, so no block idles past len;
//   inside a block, warp w takes every nw-th tile of that share.
// * Warps work alone: each warp has its own ring of kStages K/V tiles in
//   shared memory, filled with 16-byte `cp.async.cg` copies (no tensor map:
//   each row's address comes from the block table; lane j finds row j's,
//   neighbouring lanes copy neighbouring chunks of a row).  The whole ring
//   is requested before anything else waits, q's loads ahead of it, and a
//   stage is refilled as soon as it is consumed; a tile needs only
//   `cp.async.wait_group` and two `__syncwarp`s, no block barrier.
// * bf16 at D a multiple of 16 (every bf16 width but 8) runs on the tensor
//   cores (`MmaMath`): S = Q K^T and O += P V as `mma.sync` m16n8k16 with
//   the G query heads as the rows (G <= 8: rows 0-7, rows 8-15 zero; G up
//   to 16, nemotron-4-340b's 12: all 16, each lane two heads' m, l and
//   O), K through `ldmatrix` and V through
//   `ldmatrix.trans` from padded rows, P straight from the score
//   accumulators into the A operand in bf16 (as the flash forward does);
//   a head's max and sum take two shuffles.  On the CUDA cores instead,
//   the first body took 0.037 ms at the llama3.2-3b shape, most of it
//   instruction latency with 8 warps an SM.
// * float32, and bf16 at D 8, stay on the CUDA cores (`CoreMath`): a lane
//   (or two, or four) a position, q of all G heads read from shared memory
//   as a broadcast, one warp max a head a tile; in P V lanes own 16-byte
//   column chunks (two a lane at float32 D 192, whose row has 48) and lane
//   groups take the rows in turn.  Float32 must agree with the plain
//   version to ~1e-6, which TF32 tensor cores would not.
// * G is a compile-time bucket, <= 8 or <= 16, one library each: the
//   softmax state and the combine's shared memory are sized by it, so the
//   G <= 8 shapes keep the registers and the shared memory they had before
//   G 16 was added.
// * Combine, in a fixed order: each warp leaves (m, l, acc[G, D]) in
//   shared memory; each block combines its warps and stores the result
//   into its slot in rank 0's shared memory (distributed shared memory
//   stores, which wait on no round trip; a split cluster barrier at the
//   start makes sure every block has started); after one cluster barrier
//   rank 0 combines the blocks in rank order and writes the output.  One
//   launch, no workspace, no atomics.
//
// What this design still leaves: the host picks the split without the
// lengths, so short sequences in a large cache get splits with nothing to
// do; the first K/V bytes of every warp arrive only after ~5 us (the whole
// grid's requests queue at once), so a call is still about twice its
// bound; D 8 and 16 leave most lanes of the CUDA cores' P V idle.
//
// Supported: float32 and bfloat16 inputs, D in {8, 16, 32, 64, 80, 128,
// 192}, G <= 16, block_size <= 64, K/V 16-byte aligned.  At D 192
// (float32) or G above 8 the shared memory may not hold 8 splits of a
// sequence: `choose_shape` then halves the split until it fits, which 4
// warps and one block always do (a static_assert in `launch_d`).  The C
// entry points return the launch's error, then cudaGetLastError() (or
// cudaErrorInvalidValue for an unsupported shape); the Python wrapper
// raises on any non-zero value.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 8;  // warps a block: 4 or 8, picked by the host
constexpr int kStages = 2;  // K/V tiles in each warp's ring
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
// The bucket of G this library is built for: query heads a kv head, at
// most 8 or at most 16 (`nvcc -DREPRO_DECODE_MAX_G=16`; kernel.py builds
// both, each its own library, at once).
#ifndef REPRO_DECODE_MAX_G
#define REPRO_DECODE_MAX_G 8
#endif
constexpr int kMaxG = REPRO_DECODE_MAX_G;
static_assert(kMaxG == 8 || kMaxG == 16, "G's buckets are 8 and 16");
constexpr int kMaxBlockSize = 64;
constexpr int kMaxSplits = 8;  // blocks of a cluster (the portable limit)
constexpr int kPad = 16;  // bytes after each staged row: rows land on
                          // different banks when lanes read down a column
constexpr float kNegInf = -1e30f;

template <typename T, int D>
struct Tile {
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements a chunk
  static constexpr int kChunks = D / kVec;  // 16-byte chunks a row
  static_assert(D % kVec == 0, "rows must split into 16-byte chunks");
  // lanes a position in Q K^T: 4 for a row over 512 bytes (float32 D 192,
  // whose 16-row tiles would not fit 4 warps' rings beside the combine)
  static constexpr int kParts = D * (int)sizeof(T) > 512   ? 4
                                : D * (int)sizeof(T) >= 128 ? 2
                                                            : 1;
  static_assert(kChunks % kParts == 0, "a row's parts must be equal");
  static constexpr int kRows = 32 / kParts;  // positions a tile
  static constexpr int kRowBytes = D * (int)sizeof(T) + kPad;
  static constexpr int kStageBytes = 2 * kRows * kRowBytes;  // K, then V
  // P V: a lane owns kLaneChunks chunks of a row (2 at float32 D 192, whose
  // row has 48), kPVLanes lanes a row, kGroups rows at a time
  static constexpr int kLaneChunks = (kChunks + 31) / 32;
  static constexpr int kPVLanes = kChunks / kLaneChunks;
  static_assert(kPVLanes * kLaneChunks == kChunks,
                "a row's chunks must split evenly over the lanes");
  static constexpr int kGroups = 32 / kPVLanes;  // lane groups in P V
};

// Dynamic shared memory: the warps' rings, q [G][D], each warp's partial
// acc [warps][G][D], m and l [warps][MG]; then, read in rank 0 only,
// every block's acc [splits][G][D], m and l [splits][MG] (float32).
template <typename T, int D, int MG>
constexpr int smem_bytes(int G, int splits, int warps) {
  return warps * kStages * Tile<T, D>::kStageBytes +
         (G * D + (warps + splits) * (G * D + 2 * MG)) * (int)sizeof(float);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One 16-byte chunk of shared memory as float32.
__device__ __forceinline__ void unpack(const unsigned char* p,
                                       float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void unpack(const unsigned char* p,
                                       float (&f)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Row addressing of a block-paged store [N, bs, Hkv, D] through tables
// [B, mb].
struct PagedRows {
  const int* tables;
  int bs, mb, Hkv;
  __device__ int n_pos(int len) const { return min(len, mb * bs); }
  __device__ size_t offset(int b, int pos, int h, int D) const {
    const int lb = pos / bs;
    const int phys = tables[(size_t)b * mb + lb];
    return (((size_t)phys * bs + (pos - lb * bs)) * Hkv + h) * D;
  }
};

// Row addressing of contiguous caches [B, S, Hkv, D].
struct ContiguousRows {
  int S, Hkv;
  __device__ int n_pos(int len) const { return min(len, S); }
  __device__ size_t offset(int b, int pos, int h, int D) const {
    return (((size_t)b * S + pos) * Hkv + h) * D;
  }
};

// The online softmax of one warp on the CUDA cores (float32, and bf16 at
// D 8): a tile is kRows positions, one a lane (two lanes a row when a row
// is 128 bytes or more, four when it is over 512, joined by shuffles); q of
// all G heads is read from shared memory as a broadcast; one warp max a
// head a tile, each lane its own share of the row sum; in P V lanes own
// 16-byte column chunks of a V row and lane groups take the rows in turn,
// p reaching them by a shuffle.  MG (8 or 16) sizes the per-head state.
template <typename T, int D, int MG>
struct CoreMath {
  using L = Tile<T, D>;
  static constexpr int kVec = L::kVec;
  static constexpr int kAcc = kVec * L::kLaneChunks;  // floats of a head
  float m[MG], l[MG], acc[MG][kAcc];

  __device__ void init(const float*, int, int) {
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[g][e] = 0.f;
    }
  }

  __device__ void tile(const unsigned char* kt, const unsigned char* vt,
                       int n, const float* q_s, int G, float scale,
                       int lane) {
    const int r = lane % L::kRows;  // this lane's row
    const int part = lane / L::kRows;
    float s[MG];
#pragma unroll
    for (int g = 0; g < MG; ++g) s[g] = 0.f;
    if (r < n) {
#pragma unroll
      for (int cc = 0; cc < L::kChunks / L::kParts; ++cc) {
        const int c = cc * L::kParts + part;
        float kf[kVec];
        unpack(kt + r * L::kRowBytes + 16 * c, kf);
#pragma unroll
        for (int g = 0; g < MG; ++g) {
          if (g < G) {
            const float4* qg =
                reinterpret_cast<const float4*>(q_s + g * D + c * kVec);
#pragma unroll
            for (int e = 0; e < kVec / 4; ++e) {
              const float4 qv = qg[e];
              s[g] = fmaf(qv.x, kf[4 * e], s[g]);
              s[g] = fmaf(qv.y, kf[4 * e + 1], s[g]);
              s[g] = fmaf(qv.z, kf[4 * e + 2], s[g]);
              s[g] = fmaf(qv.w, kf[4 * e + 3], s[g]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g < G) {
#pragma unroll
        for (int off = L::kRows; off < 32; off <<= 1)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
        const float sv = r < n ? s[g] * scale : kNegInf;
        const float m_new = fmaxf(m[g], warp_max(sv));
        const float p = r < n ? expf(sv - m_new) : 0.f;
        const float alpha = expf(m[g] - m_new);
        l[g] = l[g] * alpha + (part == 0 ? p : 0.f);
        m[g] = m_new;
        s[g] = p;
#pragma unroll
        for (int e = 0; e < kAcc; ++e) acc[g][e] *= alpha;
      }
    }
    const int cl = lane % L::kPVLanes;  // this lane's first column chunk
    const int grp = lane / L::kPVLanes;
    for (int j0 = 0; j0 < n; j0 += L::kGroups) {
      const int j = j0 + grp;
      const bool mine = grp < L::kGroups && j < n;
      float vf[L::kLaneChunks][kVec];
      if (mine) {
#pragma unroll
        for (int lc = 0; lc < L::kLaneChunks; ++lc)
          unpack(vt + j * L::kRowBytes + 16 * (cl + lc * L::kPVLanes),
                 vf[lc]);
      }
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g < G) {
          const float pj = __shfl_sync(0xffffffffu, s[g], j & 31);
          if (mine) {
#pragma unroll
            for (int lc = 0; lc < L::kLaneChunks; ++lc)
#pragma unroll
              for (int e = 0; e < kVec; ++e)
                acc[g][lc * kVec + e] =
                    fmaf(pj, vf[lc][e], acc[g][lc * kVec + e]);
          }
        }
      }
    }
  }

  // the warp's (m, l, acc[G, D]): sums over lanes and lane groups in a
  // fixed order
  __device__ void flush(float* part_acc, float* part_m, float* part_l,
                        int warp, int G, int lane) {
    const int cl = lane % L::kPVLanes;
    const int grp = lane / L::kPVLanes;
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g < G) {
        const float lsum = warp_sum(l[g]);
#pragma unroll
        for (int lc = 0; lc < L::kLaneChunks; ++lc) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float mine = acc[g][lc * kVec + e];
            float a = mine;
            if constexpr (32 % L::kPVLanes == 0) {
#pragma unroll
              for (int off = L::kPVLanes; off < 32; off <<= 1)
                a += __shfl_xor_sync(0xffffffffu, a, off);
            } else {
              a = __shfl_sync(0xffffffffu, mine, cl);
#pragma unroll
              for (int t = 1; t < L::kGroups; ++t)
                a += __shfl_sync(0xffffffffu, mine, cl + t * L::kPVLanes);
            }
            if (grp == 0)
              part_acc[(warp * G + g) * D +
                       (cl + lc * L::kPVLanes) * kVec + e] = a;
          }
        }
        if (lane == 0) {
          part_m[warp * MG + g] = m[g];
          part_l[warp * MG + g] = lsum;
        }
      }
    }
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += A B, m16n8k16, bf16 in, float32 accumulators; A rows 8-15 are zero
// here (G <= 8 query heads fill rows 0-7), so their two registers are 0.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// The same with all 16 rows of A (G up to 16 query heads).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += A B with A's registers in a[h * kH + hh] (column half h, row half
// hh): rows 0-7 only (kH 1) or all 16 (kH 2).
template <int kH>
__device__ __forceinline__ void mma_rows(float (&d)[4],
                                         const uint32_t (&a)[2 * kH],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (kH == 1)
    mma_bf16(d, a[0], a[1], b0, b1);
  else
    mma_bf16(d, a[0], a[1], a[2], a[3], b0, b1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// The online softmax of one warp on the tensor cores (bf16, D a multiple
// of 16): S = Q K^T and O += P V as mma.sync m16n8k16 with the G query
// heads as the rows (lane l holds head l / 4, and head l / 4 + 8 when MG is
// 16), K read by ldmatrix and V by ldmatrix.trans from the padded rows; P
// goes from the score accumulators to the A operand of P V in registers,
// rounded to bf16 as the flash forward does.  A row's max and sum take two
// shuffles (the four lanes of a head).
template <int D, int MG>
struct MmaMath {
  using L = Tile<__nv_bfloat16, D>;
  static constexpr int kH = MG > 8 ? 2 : 1;  // heads a lane: rows g, g + 8
  static constexpr int kK = D / 16;          // k-steps of Q K^T
  static constexpr int kN = L::kRows / 8;    // n-tiles of S
  static constexpr int kDN = D / 8;          // n-tiles of O
  uint32_t qa[kK][2 * kH];  // A fragments of q: two d pairs of each head
  float m[kH], l[kH], o[kDN][4];

  __device__ void init(const float* q_s, int G, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int hh = 0; hh < kH; ++hh) {
          const int d = 16 * kk + 8 * h + 2 * t;
          const int gg = g + 8 * hh;
          qa[kk][h * kH + hh] =
              gg < G ? pack_bf16(q_s[gg * D + d], q_s[gg * D + d + 1]) : 0u;
        }
#pragma unroll
    for (int hh = 0; hh < kH; ++hh) {
      m[hh] = kNegInf;
      l[hh] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kDN; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  }

  __device__ void tile(const unsigned char* kt, const unsigned char* vt,
                       int n, const float*, int, float scale, int lane) {
    const int t = lane & 3;
    const int mi = lane >> 3, mj = lane & 7;  // ldmatrix: matrix, row
    const uint32_t k_s = static_cast<uint32_t>(__cvta_generic_to_shared(kt));
    const uint32_t v_s = static_cast<uint32_t>(__cvta_generic_to_shared(vt));
    float s[kN][4];
#pragma unroll
    for (int nt = 0; nt < kN; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
      for (int np = 0; np < kN / 2; ++np) {
        // matrices (rows 16 np + 0..7 | + 8..15) x (d 16 kk | + 8)
        uint32_t b[4];
        ldmatrix_x4(b, k_s + (16 * np + (mi >> 1) * 8 + mj) * L::kRowBytes +
                           (16 * kk + (mi & 1) * 8) * 2);
        mma_rows<kH>(s[2 * np], qa[kk], b[0], b[1]);
        mma_rows<kH>(s[2 * np + 1], qa[kk], b[2], b[3]);
      }
    }
    // this lane's heads (accumulators 2 hh, 2 hh + 1): positions nt * 8 +
    // 2 t and + 1 of every n-tile
    float alpha[kH];
#pragma unroll
    for (int hh = 0; hh < kH; ++hh) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kN; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int pos = nt * 8 + 2 * t + c;
          float& sv = s[nt][2 * hh + c];
          sv = pos < n ? sv * scale : kNegInf;
          mx = fmaxf(mx, sv);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      alpha[hh] = expf(m[hh] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kN; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int pos = nt * 8 + 2 * t + c;
          float& sv = s[nt][2 * hh + c];
          sv = pos < n ? expf(sv - m_new) : 0.f;
          sum += sv;
        }
      l[hh] = l[hh] * alpha[hh] + sum;
      m[hh] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kDN; ++j)
#pragma unroll
      for (int hh = 0; hh < kH; ++hh) {
        o[j][2 * hh] *= alpha[hh];
        o[j][2 * hh + 1] *= alpha[hh];
      }
#pragma unroll
    for (int ks = 0; ks < kN / 2; ++ks) {
      uint32_t pa[2 * kH];  // P's A fragments, as qa's
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int hh = 0; hh < kH; ++hh)
          pa[h * kH + hh] = pack_bf16(s[2 * ks + h][2 * hh],
                                      s[2 * ks + h][2 * hh + 1]);
#pragma unroll
      for (int dp = 0; dp < kDN / 2; ++dp) {
        // matrices (rows 16 ks + 0..7 | + 8..15) x (d 16 dp | + 8),
        // transposed: B fragments of V for n-tiles 2 dp and 2 dp + 1
        uint32_t b[4];
        ldmatrix_x4_trans(b, v_s + (16 * ks + (mi & 1) * 8 + mj) *
                                       L::kRowBytes +
                                   (16 * dp + (mi >> 1) * 8) * 2);
        mma_rows<kH>(o[2 * dp], pa, b[0], b[1]);
        mma_rows<kH>(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  }

  __device__ void flush(float* part_acc, float* part_m, float* part_l,
                        int warp, int G, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int hh = 0; hh < kH; ++hh) {
      const int gg = g + 8 * hh;
      float lsum = l[hh] + __shfl_xor_sync(0xffffffffu, l[hh], 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      if (gg < G) {
        float* pa = part_acc + (warp * G + gg) * D + 2 * t;
#pragma unroll
        for (int j = 0; j < kDN; ++j) {
          pa[8 * j] = o[j][2 * hh];
          pa[8 * j + 1] = o[j][2 * hh + 1];
        }
        if (t == 0) {
          part_m[warp * MG + gg] = m[hh];
          part_l[warp * MG + gg] = lsum;
        }
      }
    }
  }
};

template <typename T, int D>
constexpr bool kTensorCores = sizeof(T) == 2 && D % 16 == 0;

template <typename T, int D, typename Rows, int MG>
__global__ void __launch_bounds__(32 * kMaxWarps)
decode_kernel(const T* __restrict__ q,      // [B, Hkv, G, D]
              const T* __restrict__ k,      // rows addressed by Rows
              const T* __restrict__ v,
              const int* __restrict__ lens, // [B]
              T* __restrict__ out,          // [B, Hkv, G, D]
              float* __restrict__ lse,      // [B, Hkv, G] or null
              Rows rows, int Hkv, int G, int splits, float scale) {
  using L = Tile<T, D>;
  using Math = std::conditional_t<kTensorCores<T, D>, MmaMath<D, MG>,
                                  CoreMath<T, D, MG>>;
  constexpr int kVec = L::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  // a block may write another's shared memory only once that block has
  // started: arrive now, wait just before the first such write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int h = blockIdx.x / splits;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int GD = G * D;
  unsigned char* ring = smem + warp * kStages * L::kStageBytes;
  float* q_s = reinterpret_cast<float*>(smem + nw * kStages * L::kStageBytes);
  float* part_acc = q_s + GD;                    // [nw][G][D]
  float* part_m = part_acc + nw * GD;            // [nw][MG]
  float* part_l = part_m + nw * MG;
  float* blk_acc = part_l + nw * MG;             // [splits][G][D]
  float* blk_m = blk_acc + splits * GD;          // [splits][MG]
  float* blk_l = blk_m + splits * MG;

  // q first, into registers, so its loads queue ahead of the K/V copies
  // (a block has at least 128 threads)
  constexpr int kQPer = (MG * D + 127) / 128;
  const T* qb = q + ((size_t)b * Hkv + h) * GD;
  float qv[kQPer];
#pragma unroll
  for (int j = 0; j < kQPer; ++j) {
    const int idx = tid + j * blockDim.x;
    qv[j] = idx < GD ? to_float(qb[idx]) : 0.f;
  }

  // this warp's tiles: every nw-th of the block's even share
  const int n_pos = rows.n_pos(lens[b]);
  const int n_tiles = (n_pos + L::kRows - 1) / L::kRows;
  const int per = (n_tiles + splits - 1) / splits;
  const int first = rank * per + warp;
  const int last = min((rank + 1) * per, n_tiles);
  const int count = first < last ? (last - first + nw - 1) / nw : 0;

  // the i-th tile of this warp into stage i % kStages (an empty group past
  // the last, so the wait below counts the same every iteration): lane j
  // finds row j's address, then the warp copies whole rows, neighbouring
  // lanes on neighbouring 16-byte chunks.  V rows past the length are
  // zeroed (the tensor cores multiply them by p = 0, and stale shared
  // memory may hold a NaN).
  auto stage = [&](int i) {
    if (i < count) {
      const int t0 = (first + i * nw) * L::kRows;
      const size_t my_off =
          lane < L::kRows && t0 + lane < n_pos
              ? rows.offset(b, t0 + lane, h, D) : 0;
      unsigned char* kd = ring + (i % kStages) * L::kStageBytes;
      unsigned char* vd = kd + L::kRows * L::kRowBytes;
#pragma unroll
      for (int it = 0; it < L::kRows * L::kChunks / 32; ++it) {
        const int row = (it * 32 + lane) / L::kChunks;
        const int c = (it * 32 + lane) % L::kChunks;
        const size_t off = __shfl_sync(0xffffffffu, my_off, row) + c * kVec;
        if (t0 + row < n_pos) {
          cp_async16(kd + row * L::kRowBytes + 16 * c, k + off);
          cp_async16(vd + row * L::kRowBytes + 16 * c, v + off);
        } else if (kTensorCores<T, D>) {
          *reinterpret_cast<uint4*>(vd + row * L::kRowBytes + 16 * c) =
              make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int i = 0; i < kStages; ++i) stage(i);  // fill the whole ring
#pragma unroll
  for (int j = 0; j < kQPer; ++j) {
    const int idx = tid + j * blockDim.x;
    if (idx < GD) q_s[idx] = qv[j];
  }
  __syncthreads();

  Math math;
  math.init(q_s, G, lane);
  for (int i = 0; i < count; ++i) {
    cp_async_wait<kStages - 1>();  // tile i has landed
    __syncwarp();
    const unsigned char* kt = ring + (i % kStages) * L::kStageBytes;
    math.tile(kt, kt + L::kRows * L::kRowBytes,
              min(L::kRows, n_pos - (first + i * nw) * L::kRows), q_s, G,
              scale, lane);
    __syncwarp();  // every lane is done with this stage: refill it
    stage(i + kStages);
  }
  cp_async_wait<0>();
  math.flush(part_acc, part_m, part_l, warp, G, lane);

  // this block's state, over its warps in order, into rank 0's slot for
  // it; then rank 0 combines the blocks in rank order
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  float* blk_acc0 = cluster.map_shared_rank(blk_acc, 0);
  float* blk_m0 = cluster.map_shared_rank(blk_m, 0);
  float* blk_l0 = cluster.map_shared_rank(blk_l, 0);
  for (int idx = tid; idx < GD; idx += blockDim.x) {
    const int g = idx / D;
    float mx = kNegInf;
    for (int w = 0; w < nw; ++w) mx = fmaxf(mx, part_m[w * MG + g]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float f = expf(part_m[w * MG + g] - mx);
      lsum += f * part_l[w * MG + g];
      a += f * part_acc[w * GD + idx];
    }
    blk_acc0[rank * GD + idx] = a;
    if (idx == g * D) {
      blk_m0[rank * MG + g] = mx;
      blk_l0[rank * MG + g] = lsum;
    }
  }
  cluster.sync();  // release / acquire: rank 0 sees every block's stores
  if (rank != 0) return;
  for (int idx = tid; idx < GD; idx += blockDim.x) {
    const int g = idx / D;
    float mx = kNegInf;
    for (int qr = 0; qr < splits; ++qr) mx = fmaxf(mx, blk_m[qr * MG + g]);
    float lsum = 0.f, a = 0.f;
    for (int qr = 0; qr < splits; ++qr) {
      const float f = expf(blk_m[qr * MG + g] - mx);
      lsum += f * blk_l[qr * MG + g];
      a += f * blk_acc[qr * GD + idx];
    }
    out[((size_t)b * Hkv + h) * GD + idx] =
        from_float<T>(a / fmaxf(lsum, 1e-30f));
    if (lse != nullptr && idx == g * D)
      lse[((size_t)b * Hkv + h) * G + g] =
          lsum > 0.f ? mx + logf(lsum) : __int_as_float(0xff800000);  // -inf
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 132;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      count = 132;
    return count;
  }();
  return n;
}

struct Shape {
  int splits;  // blocks (the cluster) a (sequence, kv head) takes
  int warps;   // warps a block
};

// The launch shape, from shapes alone (the lengths stay on the device):
// the split doubles while the grid stays within one block an SM and a full
// cache gives every block at least 8 tiles; a block gets 8 warps when the
// grid fits one block an SM and the shared memory allows, else 4, so that
// two or more blocks share an SM; then, where the combine's shared memory
// for 8 splits is too much (float32 D 192, or G above 8), the split halves
// until the block fits (4 warps of one block always do: `launch_d`).
template <typename T, int D, int MG>
Shape choose_shape(int B, int Hkv, int G, int cap) {
  const long long pairs = (long long)B * Hkv;
  const int sms = sm_count();
  const int tiles = (cap + Tile<T, D>::kRows - 1) / Tile<T, D>::kRows;
  int splits = 1;
  while (splits < kMaxSplits && pairs * 2 * splits <= sms &&
         2 * splits * 8 <= tiles)
    splits *= 2;
  const bool wide = pairs * splits <= sms &&
                    smem_bytes<T, D, MG>(G, splits, kMaxWarps) <= kMaxSmem;
  const int warps = wide ? kMaxWarps : kMaxWarps / 2;
  while (splits > 1 && smem_bytes<T, D, MG>(G, splits, warps) > kMaxSmem)
    splits /= 2;
  return {splits, warps};
}

template <typename T, int D, typename Rows, int MG>
int launch_d(const T* q, const T* k, const T* v, const int* lens, T* out,
             float* lse, Rows rows, int B, int Hkv, int G, int cap,
             float scale, cudaStream_t stream) {
  static_assert(smem_bytes<T, D, MG>(MG, 1, kMaxWarps / 2) <= kMaxSmem,
                "choose_shape's search must end in a shape that fits");
  auto kern = decode_kernel<T, D, Rows, MG>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const Shape shape = choose_shape<T, D, MG>(B, Hkv, G, cap);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = shape.splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Hkv * shape.splits, B);
  cfg.blockDim = dim3(32 * shape.warps);
  cfg.dynamicSmemBytes = smem_bytes<T, D, MG>(G, shape.splits, shape.warps);
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kern, q, k, v, lens, out, lse, rows, Hkv, G,
                         shape.splits, scale);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <typename T, typename Rows, int MG>
int launch(const void* q, const void* k, const void* v, const void* lens,
           void* out, float* lse, Rows rows, int B, int Hkv, int G, int D,
           int cap, float scale, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* lt = static_cast<const int*>(lens);
  T* ot = static_cast<T*>(out);
#define REPRO_DECODE_CASE(DIM)                                             \
  case DIM:                                                                \
    return launch_d<T, DIM, Rows, MG>(qt, kt, vt, lt, ot, lse, rows, B,    \
                                      Hkv, G, cap, scale, s);
  switch (D) {
    REPRO_DECODE_CASE(8)
    REPRO_DECODE_CASE(16)
    REPRO_DECODE_CASE(32)
    REPRO_DECODE_CASE(64)
    REPRO_DECODE_CASE(80)
    REPRO_DECODE_CASE(128)
    REPRO_DECODE_CASE(192)
  }
#undef REPRO_DECODE_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T, int MG>
Shape shape_for(int B, int Hkv, int G, int D, int cap) {
  switch (D) {
    case 8: return choose_shape<T, 8, MG>(B, Hkv, G, cap);
    case 16: return choose_shape<T, 16, MG>(B, Hkv, G, cap);
    case 32: return choose_shape<T, 32, MG>(B, Hkv, G, cap);
    case 64: return choose_shape<T, 64, MG>(B, Hkv, G, cap);
    case 80: return choose_shape<T, 80, MG>(B, Hkv, G, cap);
    case 128: return choose_shape<T, 128, MG>(B, Hkv, G, cap);
    case 192: return choose_shape<T, 192, MG>(B, Hkv, G, cap);
  }
  return {-1, -1};
}

template <typename Rows>
int dispatch(int dtype, const void* q, const void* k, const void* v,
             const void* lens, void* out, float* lse, Rows rows, int B,
             int Hkv, int G, int D, int cap, float scale, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > (1 << 27) || G <= 0 ||
      G > kMaxG)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, Rows, kMaxG>(q, k, v, lens, out, lse, rows, B, Hkv,
                                      G, D, cap, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, Rows, kMaxG>(q, k, v, lens, out, lse, rows,
                                              B, Hkv, G, D, cap, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Tables and lengths are int32.
extern "C" int paged_decode_attention(int dtype, const void* q, const void* k,
                                      const void* v, const void* tables,
                                      const void* lens, void* out, int B,
                                      int Hkv, int G, int D, int bs, int mb,
                                      float scale, void* stream) {
  if (bs <= 0 || bs > kMaxBlockSize || mb <= 0)
    return (int)cudaErrorInvalidValue;
  const PagedRows rows{static_cast<const int*>(tables), bs, mb, Hkv};
  return dispatch(dtype, q, k, v, lens, out, nullptr, rows, B, Hkv, G, D,
                  bs * mb, scale, stream);
}

// Contiguous caches [B, S, Hkv, D]; lengths int32 (clamped to S, 0
// allowed: out 0, lse -inf).  `lse`, when not null, receives each query
// head's float32 log-sum-exp of its scaled scores, [B, Hkv, G]: what a
// caller needs to combine the outputs of several sequence shards.
extern "C" int decode_attention(int dtype, const void* q, const void* k,
                                const void* v, const void* lens, void* out,
                                void* lse, int B, int Hkv, int G, int D,
                                int S, float scale, void* stream) {
  if (S <= 0) return (int)cudaErrorInvalidValue;
  const ContiguousRows rows{S, Hkv};
  return dispatch(dtype, q, k, v, lens, out, static_cast<float*>(lse), rows,
                  B, Hkv, G, D, S, scale, stream);
}

// The launch shape either entry point takes for these shapes (cap = S or
// block_size * max_blocks): blocks (the cluster's size) a (sequence, kv
// head) and warps a block; -1 for an unsupported dtype or shape.
extern "C" int decode_attention_shape(int dtype, int B, int Hkv, int G, int D,
                                      int cap, int* splits, int* warps) {
  Shape shape{-1, -1};
  if (B > 0 && Hkv > 0 && G > 0 && G <= kMaxG && cap > 0) {
    if (dtype == 0) shape = shape_for<float, kMaxG>(B, Hkv, G, D, cap);
    if (dtype == 1)
      shape = shape_for<__nv_bfloat16, kMaxG>(B, Hkv, G, D, cap);
  }
  *splits = shape.splits;
  *warps = shape.warps;
  return shape.splits > 0 ? 0 : -1;
}
