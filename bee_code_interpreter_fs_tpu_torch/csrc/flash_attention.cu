// Flash attention forward for NVIDIA Hopper (sm_90a): the full causal
// kernel and the ring-step kernel, one tile loop for both.
//
// Replaces the two Pallas TPU kernels of bee_code_interpreter_fs_tpu/ops/
// flash_attention.py:
// - `_flash_kernel` (:103, launched by `flash_attention` at :461):
//   out = softmax(Q K^T * scale) V over [b, t, h, d] with the causal mask,
//   the padding tail, a sliding window and StreamingLLM attention sinks.
// - `_flash_partial_kernel` (:193, launched by `flash_attention_partial` at
//   :331): one ring step. A K/V chunk [b, tk, h, d] is folded into the
//   running (acc, m, l) online-softmax carry of a Q chunk [b, tq, h, d];
//   positions are global (q_offset, k_offset), the chunk's tail past tk is
//   masked, the mask is causal or not, and the result stays unnormalized
//   (the caller divides acc by l after the last step). The carry is read
//   and written in place, as the TPU kernel aliases it.
// Both fold key tiles with the online-softmax recurrence, so the [tq, tk]
// score matrix never reaches device memory. The kernels differ only at the
// two ends of the loop: the full kernel starts from an empty carry and
// writes acc / l in q's dtype; the ring step reads its rows of the f32
// carry first and writes them back last (template flag kPartial).
//
// What bounds them on an H100: at Llama-2-7B width (b=2, t=2048, h=32,
// d=128, causal) the full kernel does 4*b*h*d*t(t+1)/2 = 68.7 GFLOP and must
// move q, k, v and out once, 134 MB: ~70 us at 989 TFLOP/s (bf16 tensor
// cores) against ~40 us at 3.35 TB/s, so it is compute-bound. A ring step
// on one [1, 2048, 32, 128] chunk pair also moves the f32 carry in and out,
// 118.5 MB: ~35 us by bytes against 34.4 GFLOP (~35 us) on the causal
// diagonal, and 68.7 GFLOP (~70 us, compute-bound) on a fully visible chunk.
// What matters is keeping the tensor cores fed and doing no dead work.
//
// What the design does about it:
// - One thread block per (q-tile, b*h). The block loops over only the live
//   key range of its q-tile: from the window start (or 0 while sink tiles
//   are live) up to the causal frontier, in the chunk's coordinates. Dead
//   tiles cost neither loads nor math; this replaces the TPU's sequential
//   key grid axis and its `kv_index` clamp. A ring step's q-tile with no
//   live key tile returns at once and leaves its carry untouched, bit for
//   bit. Q tiles are visited last-first, so the longest rows of the causal
//   triangle start first and the tail is short.
// - bf16: each of 4 warps owns 16 query rows; Q lives in registers as
//   mma.sync m16n8k16 A fragments for the whole loop. K and V tiles
//   (64 keys) are copied to shared memory with cp.async, double-buffered so
//   the next live tile loads while this one computes; rows are padded so
//   the ldmatrix fragment loads (transposed for V) hit no bank conflicts.
//   S = Q K^T and O += P V run on the tensor cores with f32 accumulators;
//   the score accumulator is reused in registers as the A operand of P V
//   (no shared-memory round trip for P). Only tiles on the causal diagonal,
//   the window edge or the padding tail build a mask, and the softmax runs
//   in the log2 domain (one exp2 per score); the carry's m crosses between
//   the natural and the log2 domain at the loop's two ends, with -1e30 kept
//   as -1e30 both ways.
// - f32: plain FMA loops (16 query rows x 32 keys per tile, 8 threads per
//   row); f32 is the exactness check, not the fast path.
// - Numerics follow `_tile_update` (flash_attention.py:67-100): scores and
//   the (acc, m, l) carry are f32, masked scores are -1e30 (not -inf),
//   P is rounded to V's dtype before the P V product, l sums the unrounded
//   P, out = acc / l in q's dtype.
// - q, k, v and out are read in their [b, t, h, d] layout through strides:
//   no transposes around the call. The carry is contiguous [b, h, tq, d]
//   and [b, h, tq].
//
// A simple kernel that is right; wgmma, TMA and warp specialization are
// later work. Built by bee_code_interpreter_fs_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;     // full kernel: output [b, tq, h, d] in q's dtype
  float* acc;  // ring step: carry [b, h, tq, d], m and l [b, h, tq], f32
  float* m;
  float* l;
  long long q_sb, q_st, q_sh;  // strides in elements: batch, seq, head
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  int tq, tk, h;     // query rows, keys (the chunk's klen), heads
  int q_off, k_off;  // global positions of query row 0 and key 0
  int causal;
  float scale;
  int window, sinks;
};

// The live key range of the q-tile whose first row is q0, in the chunk's
// key indices: keys in [first, last] plus, with a window, the sink tiles
// before `first`. Masks compare global positions.
struct KeyRange {
  int first;       // first key any row of the tile can see past the sinks
  int last;        // causal frontier of the tile's last real row
  int tile_begin;  // first key tile to visit
  int tile_end;    // one past the last key tile to visit (0: none is live)
};

__device__ __forceinline__ KeyRange key_range(const Params& p, int q0, int bq,
                                              int bk) {
  KeyRange r;
  const int q_first = p.q_off + q0;
  const int q_last = p.q_off + min(q0 + bq, p.tq) - 1;
  r.last = p.causal ? min(q_last - p.k_off, p.tk - 1) : p.tk - 1;
  r.first = p.window > 0 ? max(q_first - p.window + 1 - p.k_off, 0) : 0;
  r.tile_begin = (p.window > 0 && p.sinks > 0) ? 0 : r.first / bk;
  r.tile_end = r.last < 0 ? 0 : r.last / bk + 1;
  return r;
}

__device__ __forceinline__ bool tile_live(const Params& p, const KeyRange& r,
                                          int k0, int bk) {
  return k0 + bk - 1 >= r.first || (p.window > 0 && p.k_off + k0 < p.sinks);
}

__device__ __forceinline__ bool visible(const Params& p, int row, int key) {
  const int qp = p.q_off + row;
  const int kp = p.k_off + key;
  bool vis = key < p.tk && (!p.causal || kp <= qp);
  if (p.window > 0) vis = vis && (kp > qp - p.window || kp < p.sinks);
  return vis;
}

// ---------------------------------------------------------------- bf16

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// 16 bytes global -> shared without registers; zero-filled when !valid.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(smem)), "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two adjacent bf16 of row `row` starting at column `col`, or zeros past t.
__device__ __forceinline__ uint32_t load_pair(const uint16_t* base,
                                              long long row_stride, int row,
                                              int col, int t) {
  if (row >= t) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + row * row_stride + col);
}

constexpr int kBq = 64;      // query rows per block: 4 warps x 16
constexpr int kBk = 64;      // keys per shared-memory tile
constexpr int kPad = 8;      // bf16 elements of row padding in shared memory
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The carry's running max between the natural domain (the reference's m)
// and the kernel's log2 domain; the -1e30 "nothing seen yet" value is the
// same in both, so a fresh row behaves as the reference's does.
__device__ __forceinline__ float to_log2(float m) {
  return m <= kNegInf ? kNegInf : m * kLog2e;
}

__device__ __forceinline__ float from_log2(float m) {
  return m <= kNegInf ? kNegInf : m * kLn2;
}

// The fields one kernel kind fixes, as compile-time constants, so that the
// shared tile loop costs neither kind anything: full attention has no
// offsets, is causal and has tk == tq; a ring step has no window or sinks.
template <bool kPartial>
__device__ __forceinline__ Params specialize(const Params& in) {
  Params p = in;
  if (kPartial) {
    p.window = 0;
    p.sinks = 0;
  } else {
    p.tk = in.tq;
    p.q_off = 0;
    p.k_off = 0;
    p.causal = 1;
  }
  return p;
}

template <int D>
constexpr int bf16_smem_bytes() {
  return 4 * kBk * (D + kPad) * 2;  // K and V, two stages each
}

// Start the copies of key tile [k0, k0 + kBk) of K and V into one stage.
template <int D>
__device__ __forceinline__ void load_kv_tile(uint16_t* ks, uint16_t* vs,
                                             const uint16_t* kb,
                                             const uint16_t* vb,
                                             const Params& p, int k0) {
  constexpr int kRow = D + kPad;
  for (int idx = threadIdx.x; idx < kBk * D / 8; idx += kThreads) {
    const int r = idx / (D / 8);
    const int c = (idx % (D / 8)) * 8;
    const int key = k0 + r;
    const bool in = key < p.tk;
    const long long row = in ? key : 0;
    cp_async_16(ks + r * kRow + c, kb + row * p.k_st + c, in);
    cp_async_16(vs + r * kRow + c, vb + row * p.v_st + c, in);
  }
  cp_async_commit();
}

__device__ __forceinline__ int next_live(const Params& p, const KeyRange& r,
                                         int j, int bk) {
  while (j < r.tile_end && !tile_live(p, r, j * bk, bk)) ++j;
  return j;
}

template <int D, bool kPartial>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const Params params) {
  const Params p = specialize<kPartial>(params);
  constexpr int kRow = D + kPad;
  constexpr int kTile = kBk * kRow;
  extern __shared__ __align__(16) uint16_t smem[];  // K0 K1 V0 V1

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row group
  const int t4 = lane & 3;   // thread within the group
  const int q0 = qt * kBq;
  const int wq0 = q0 + warp * 16;  // this warp's first and last rows
  const int wq1 = wq0 + 15;
  const int row0 = wq0 + g;
  const int row1 = row0 + 8;
  // Scores are kept in the log2 domain: exp2(s*scale*log2e - m) is the
  // reference's exp(s*scale - m') up to rounding.
  const float scale_log2 = p.scale * kLog2e;

  const KeyRange range = key_range(p, q0, kBq, kBk);
  int j = next_live(p, range, range.tile_begin, kBk);
  if (kPartial && j >= range.tile_end) return;  // carry stays as it was

  const uint16_t* qb = static_cast<const uint16_t*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const uint16_t* kb = static_cast<const uint16_t*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const uint16_t* vb = static_cast<const uint16_t*>(p.v) + bi * p.v_sb + hi * p.v_sh;

  int stage = 0;
  if (j < range.tile_end) load_kv_tile<D>(smem, smem + 2 * kTile, kb, vb, p, j * kBk);

  // Q as m16n8k16 A fragments: chunk kc covers head dims [16kc, 16kc+16).
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + 2 * t4;
    qf[kc][0] = load_pair(qb, p.q_st, row0, c, p.tq);
    qf[kc][1] = load_pair(qb, p.q_st, row1, c, p.tq);
    qf[kc][2] = load_pair(qb, p.q_st, row0, c + 8, p.tq);
    qf[kc][3] = load_pair(qb, p.q_st, row1, c + 8, p.tq);
  }

  float acc[D / 8][4];
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows row0 / row1
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums
  // Carry rows of this block's (b, h): row r of acc at carry[(cb + r) * D].
  const long long cb = static_cast<long long>(bh) * p.tq;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
  if constexpr (kPartial) {
    // Thread t4 == 0 carries the row's l; the quad's shares sum to it.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row1 : row0;
      if (row >= p.tq) continue;
      const float* arow = p.acc + (cb + row) * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const float2 a = *reinterpret_cast<const float2*>(arow + dn * 8 + 2 * t4);
        acc[dn][2 * half] = a.x;
        acc[dn][2 * half + 1] = a.y;
      }
      const float mv = to_log2(p.m[cb + row]);
      const float lv = t4 == 0 ? p.l[cb + row] : 0.f;
      if (half) { m1 = mv; l1 = lv; } else { m0 = mv; l0 = lv; }
    }
  }

  const int ld_row = lane & 7;  // ldmatrix: row within matrix lane >> 3
  const int ld_mat = lane >> 3;
  while (j < range.tile_end) {
    const int k0 = j * kBk;
    const int j_next = next_live(p, range, j + 1, kBk);
    if (j_next < range.tile_end) {  // prefetch the next live tile
      load_kv_tile<D>(smem + (stage ^ 1) * kTile, smem + (2 + (stage ^ 1)) * kTile,
                      kb, vb, p, j_next * kBk);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* ks = smem + stage * kTile;
    const uint16_t* vs = smem + (2 + stage) * kTile;

    // S = Q K^T: n-tile n covers keys [k0 + 8n, k0 + 8n + 8).
    float s[kBk / 8][4];
#pragma unroll
    for (int n = 0; n < kBk / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; kc += 2) {
#pragma unroll
      for (int n = 0; n < kBk / 8; ++n) {
        uint32_t b[4];  // B fragments of chunks kc and kc + 1
        ldmatrix_x4(b, ks + (n * 8 + ld_row) * kRow + kc * 16 + ld_mat * 8);
        mma_bf16_16816(s[n], qf[kc], b[0], b[1]);
        mma_bf16_16816(s[n], qf[kc + 1], b[2], b[3]);
      }
    }

    // Tiles wholly visible to every row of this warp need no mask.
    const bool interior =
        k0 + kBk <= p.tk &&
        (!p.causal || p.k_off + k0 + kBk - 1 <= p.q_off + wq0) &&
        (p.window == 0 || p.k_off + k0 > p.q_off + wq1 - p.window);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < kBk / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row0 : row1;
        const int key = k0 + n * 8 + 2 * t4 + (e & 1);
        s[n][e] = (interior || visible(p, row, key)) ? s[n][e] * scale_log2 : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 2));

    const float c0 = exp2f(m0 - mx0);
    const float c1 = exp2f(m1 - mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < kBk / 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mx0);
      s[n][1] = exp2f(s[n][1] - mx0);
      s[n][2] = exp2f(s[n][2] - mx1);
      s[n][3] = exp2f(s[n][3] - mx1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= c0;
      acc[dn][1] *= c0;
      acc[dn][2] *= c1;
      acc[dn][3] *= c1;
    }

    // O += P V. The S accumulators of n-tiles 2kk and 2kk+1 are exactly the
    // A fragment of keys [16kk, 16kk+16), once rounded to bf16; V's B
    // fragments come from transposing 8x8 loads of the row-major tile.
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const uint16_t* vrow = vs + (kk * 16 + (ld_mat & 1) * 8 + ld_row) * kRow + (ld_mat >> 1) * 8;
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        uint32_t b[4];  // B fragments of head-dim tiles dn and dn + 1
        ldmatrix_x4_trans(b, vrow + dn * 8);
        mma_bf16_16816(acc[dn], a, b[0], b[1]);
        mma_bf16_16816(acc[dn + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
    stage ^= 1;
    j = j_next;
  }

  l0 += __shfl_xor_sync(kFullMask, l0, 1);
  l0 += __shfl_xor_sync(kFullMask, l0, 2);
  l1 += __shfl_xor_sync(kFullMask, l1, 1);
  l1 += __shfl_xor_sync(kFullMask, l1, 2);

  if constexpr (kPartial) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row1 : row0;
      if (row >= p.tq) continue;
      float* arow = p.acc + (cb + row) * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        *reinterpret_cast<float2*>(arow + dn * 8 + 2 * t4) =
            make_float2(acc[dn][2 * half], acc[dn][2 * half + 1]);
      }
      if (t4 == 0) {
        p.m[cb + row] = from_log2(half ? m1 : m0);
        p.l[cb + row] = half ? l1 : l0;
      }
    }
  } else {
    uint16_t* ob = static_cast<uint16_t*>(p.o) + bi * p.o_sb + hi * p.o_sh;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int col = dn * 8 + 2 * t4;
      if (row0 < p.tq) {
        *reinterpret_cast<uint32_t*>(ob + row0 * p.o_st + col) =
            pack_bf16(acc[dn][0] / l0, acc[dn][1] / l0);
      }
      if (row1 < p.tq) {
        *reinterpret_cast<uint32_t*>(ob + row1 * p.o_st + col) =
            pack_bf16(acc[dn][2] / l1, acc[dn][3] / l1);
      }
    }
  }
}

// ---------------------------------------------------------------- f32

constexpr int kBqF = 16;  // query rows per block, 8 threads per row
constexpr int kBkF = 32;  // keys per shared-memory tile

template <int D, bool kPartial>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const Params params) {
  const Params p = specialize<kPartial>(params);
  __shared__ float qs[kBqF][D + 1];
  __shared__ float ks[kBkF][D + 1];
  __shared__ float vs[kBkF][D];
  __shared__ float ps[kBqF][kBkF + 1];

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int r = threadIdx.x >> 3;  // query row within the tile
  const int c8 = threadIdx.x & 7;  // thread within the row
  const int q0 = qt * kBqF;
  const int row = q0 + r;

  const KeyRange range = key_range(p, q0, kBqF, kBkF);
  if (kPartial && range.tile_end <= range.tile_begin) return;  // carry untouched

  const float* qb = static_cast<const float*>(p.q) + bi * p.q_sb + hi * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + bi * p.k_sb + hi * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + bi * p.v_sb + hi * p.v_sh;

  for (int idx = threadIdx.x; idx < kBqF * D; idx += kThreads) {
    const int rr = idx / D;
    const int c = idx % D;
    qs[rr][c] = q0 + rr < p.tq ? qb[(q0 + rr) * p.q_st + c] : 0.f;
  }

  float acc[D / 8];
#pragma unroll
  for (int jc = 0; jc < D / 8; ++jc) acc[jc] = 0.f;
  float m = kNegInf, l = 0.f;
  const long long carry_row = static_cast<long long>(bh) * p.tq + row;
  if (kPartial && row < p.tq) {
#pragma unroll
    for (int jc = 0; jc < D / 8; ++jc) acc[jc] = p.acc[carry_row * D + c8 + 8 * jc];
    m = p.m[carry_row];
    l = p.l[carry_row];
  }

  for (int j = range.tile_begin; j < range.tile_end; ++j) {
    const int k0 = j * kBkF;
    if (!tile_live(p, range, k0, kBkF)) continue;

    __syncthreads();
    for (int idx = threadIdx.x; idx < kBkF * D; idx += kThreads) {
      const int rr = idx / D;
      const int c = idx % D;
      const int key = k0 + rr;
      const bool in = key < p.tk;
      ks[rr][c] = in ? kb[key * p.k_st + c] : 0.f;
      vs[rr][c] = in ? vb[key * p.v_st + c] : 0.f;
    }
    __syncthreads();

    // This thread's keys: k0 + c8 + 8 * jj.
    float s[kBkF / 8];
    float mx = m;
#pragma unroll
    for (int jj = 0; jj < kBkF / 8; ++jj) {
      const int kl = c8 + 8 * jj;
      float dot = 0.f;
#pragma unroll 16
      for (int i = 0; i < D; ++i) dot = fmaf(qs[r][i], ks[kl][i], dot);
      s[jj] = visible(p, row, k0 + kl) ? dot * p.scale : kNegInf;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 4));

    const float corr = expf(m - mx);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kBkF / 8; ++jj) {
      const float pj = expf(s[jj] - mx);
      ps[r][c8 + 8 * jj] = pj;
      sum += pj;
    }
    sum += __shfl_xor_sync(kFullMask, sum, 1);
    sum += __shfl_xor_sync(kFullMask, sum, 2);
    sum += __shfl_xor_sync(kFullMask, sum, 4);
    l = l * corr + sum;
    m = mx;
    __syncwarp();  // a row's 8 threads share one warp

#pragma unroll
    for (int jc = 0; jc < D / 8; ++jc) {
      const int col = c8 + 8 * jc;
      float pv = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < kBkF; ++kk) pv = fmaf(ps[r][kk], vs[kk][col], pv);
      acc[jc] = acc[jc] * corr + pv;
    }
  }

  if (row >= p.tq) return;
  if constexpr (kPartial) {
#pragma unroll
    for (int jc = 0; jc < D / 8; ++jc) p.acc[carry_row * D + c8 + 8 * jc] = acc[jc];
    if (c8 == 0) {
      p.m[carry_row] = m;
      p.l[carry_row] = l;
    }
  } else {
    float* ob = static_cast<float*>(p.o) + bi * p.o_sb + hi * p.o_sh;
#pragma unroll
    for (int jc = 0; jc < D / 8; ++jc) ob[row * p.o_st + c8 + 8 * jc] = acc[jc] / l;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int bq, int smem_bytes, const Params& p,
                   int bh, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.tq + bq - 1) / bq, bh);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool kPartial>
cudaError_t dispatch(const Params& p, int bh, int d, int dtype_is_bf16,
                     cudaStream_t s) {
  if (dtype_is_bf16 && d == 128) {
    return launch(flash_fwd_bf16<128, kPartial>, kBq, bf16_smem_bytes<128>(), p, bh, s);
  } else if (dtype_is_bf16 && d == 64) {
    return launch(flash_fwd_bf16<64, kPartial>, kBq, bf16_smem_bytes<64>(), p, bh, s);
  } else if (!dtype_is_bf16 && d == 128) {
    return launch(flash_fwd_f32<128, kPartial>, kBqF, 0, p, bh, s);
  } else if (!dtype_is_bf16 && d == 64) {
    return launch(flash_fwd_f32<64, kPartial>, kBqF, 0, p, bh, s);
  }
  return cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v,
                   long long q_sb, long long q_st, long long q_sh,
                   long long k_sb, long long k_st, long long k_sh,
                   long long v_sb, long long v_st, long long v_sh,
                   int tq, int tk, int h, float scale) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.tq = tq;
  p.tk = tk;
  p.h = h;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() as an int
// (0 = launched). dtype_is_bf16 selects bf16 (1) or f32 (0); d is 64 or 128.

// Full causal attention: o = softmax(q k^T * scale) v, all [b, t, h, d].
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        long long q_sb, long long q_st, long long q_sh,
                        long long k_sb, long long k_st, long long k_sh,
                        long long v_sb, long long v_st, long long v_sh,
                        long long o_sb, long long o_st, long long o_sh,
                        int b, int t, int h, int d, int dtype_is_bf16,
                        float scale, int window, int sinks, void* stream) {
  Params p = make_params(q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                         v_sb, v_st, v_sh, t, t, h, scale);
  p.o = o;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.causal = 1;
  p.window = window;
  p.sinks = sinks;
  return static_cast<int>(dispatch<false>(p, b * h, d, dtype_is_bf16,
                                          static_cast<cudaStream_t>(stream)));
}

// One ring step: fold k/v [b, tk, h, d] (global key positions from
// k_offset) into the carry of q [b, tq, h, d] (from q_offset), in place:
// acc [b, h, tq, d], m and l [b, h, tq], f32 and contiguous.
int flash_attention_partial_fwd(const void* q, const void* k, const void* v,
                                float* acc, float* m, float* l,
                                long long q_sb, long long q_st, long long q_sh,
                                long long k_sb, long long k_st, long long k_sh,
                                long long v_sb, long long v_st, long long v_sh,
                                int b, int tq, int tk, int h, int d,
                                int dtype_is_bf16, float scale, int q_offset,
                                int k_offset, int causal, void* stream) {
  Params p = make_params(q, k, v, q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                         v_sb, v_st, v_sh, tq, tk, h, scale);
  p.acc = acc;
  p.m = m;
  p.l = l;
  p.q_off = q_offset;
  p.k_off = k_offset;
  p.causal = causal;
  return static_cast<int>(dispatch<true>(p, b * h, d, dtype_is_bf16,
                                         static_cast<cudaStream_t>(stream)));
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
