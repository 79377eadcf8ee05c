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
// So the tensor cores have to be kept fed, and only `wgmma` reaches their
// full rate on Hopper; the Ampere `mma.sync` path this design replaced ran
// at ~160 TFLOP/s.
//
// What the design does about it (bf16, the fast path):
// - One block per (q-tile of 128 rows, b*h), 384 threads in three
//   warpgroups. Warpgroups 0 and 1 consume, 64 query rows each, and ask
//   for 240 registers with setmaxnreg; warpgroup 2 produces, gives back
//   down to 24, and one of its threads issues every copy. The roles split
//   once, on a warp-uniform index, and never reconverge.
// - Copies are TMA loads through 4-D tensor maps over the [b, t, h, d]
//   tensors (dims d, h, t, b; the strides the caller passes), in 64-column
//   boxes with the 128-byte swizzle that wgmma reads. The map's t extent is
//   the tensor's own length, so TMA zero-fills rows past the end: that is
//   the padding tail, and a ring chunk may be a view into a longer tensor.
//   The Q tile arrives once; K and V tiles of 128 keys go through rings of
//   2 stages (d=128) or 3 (d=64), K and V each with a "full" mbarrier (the
//   TMA byte count) and an "empty" one (one arrival per consumer warp), so
//   a K tile is refilled as soon as its scores are done and the producer
//   runs ahead of the math by the depth of the ring.
// - S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//   (K-major). O += P V is wgmma m64n{d}k16 with P in registers: the f32
//   S accumulator, packed pairwise to bf16, is the A fragment as it stands,
//   and V is read MN-major (the transpose flag). Each consumer issues tile
//   j's S together with tile j-1's P V and runs tile j's softmax while that
//   P V is in flight, so its own softmax hides under its products as well
//   as under the other consumer's. That needs S, P and O live at once, the
//   reason for the consumers' 240 registers.
// - The block walks only the live key range of its q-tile: from the window
//   start (or 0 while sink tiles are live) up to the causal frontier, in
//   the chunk's coordinates, producer and consumers the same sequence. Dead
//   tiles cost neither loads nor math; this replaces the TPU's sequential
//   key grid axis and its `kv_index` clamp. A ring step's q-tile with no
//   live key tile returns before any barrier, copy or store, leaving its
//   carry bit for bit. Q tiles are visited last-first, so the longest rows
//   of the causal triangle start first and the tail is short.
// - Numerics follow `_tile_update` (flash_attention.py:67-100): scores and
//   the (acc, m, l) carry are f32, masked scores are -1e30 (not -inf), P is
//   rounded to bf16 before the P V product, l sums the unrounded P, out =
//   acc / l. The softmax runs in the log2 domain (one exp2 per score); the
//   carry's m crosses between the natural and the log2 domain at the loop's
//   two ends, with -1e30 kept as -1e30 both ways. Only tiles on a warp's
//   causal diagonal, the window edge or the klen tail build a mask. Row max
//   and row sum reduce over the quad of threads that holds a row.
// - f32: plain FMA loops (16 query rows x 32 keys per tile, 8 threads per
//   row); f32 is the exactness check, not the fast path.
// - The carry is contiguous [b, h, tq, d] and [b, h, tq], f32.
//
// Built by bee_code_interpreter_fs_tpu_torch/ops/_build.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// The driver's cuTensorMapEncodeTiled is looked up at run time through
// cudaGetDriverEntryPoint, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

__device__ __forceinline__ int next_live(const Params& p, const KeyRange& r,
                                         int j, int bk) {
  while (j < r.tile_end && !tile_live(p, r, j * bk, bk)) ++j;
  return j;
}

__device__ __forceinline__ bool visible(const Params& p, int row, int key) {
  const int qp = p.q_off + row;
  const int kp = p.k_off + key;
  bool vis = key < p.tk && (!p.causal || kp <= qp);
  if (p.window > 0) vis = vis && (kp > qp - p.window || kp < p.sinks);
  return vis;
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

// The carry's running max between the natural domain (the reference's m)
// and the kernel's log2 domain; the -1e30 "nothing seen yet" value is the
// same in both, so a fresh row behaves as the reference's does.
__device__ __forceinline__ float to_log2(float m) {
  return m <= kNegInf ? kNegInf : m * kLog2e;
}

__device__ __forceinline__ float from_log2(float m) {
  return m <= kNegInf ? kNegInf : m * kLn2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- bf16

constexpr int kBq = 128;           // query rows per block: 2 consumers x 64
constexpr int kBk = 128;           // keys per K/V tile
constexpr int kBoxCols = 64;       // bf16 columns in one 128-byte swizzled row
constexpr int kRowBytes = 128;     // shared-memory bytes per tile row
constexpr int kConsumers = 2;      // consumer warpgroups
constexpr int kThreadsBf16 = 128 * (kConsumers + 1);
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;  // 2 * 128 * 240 + 128 * 24 <= 65536

// Shared memory of one block, in bytes from a 1024-aligned base: the Q tile
// and the K and V stages as 64-column boxes of 128-byte swizzled rows, then
// the mbarriers.
template <int D>
struct Bf16Smem {
  static constexpr int kStages = D == 128 ? 2 : 3;  // 160 or 112 KB in all
  static constexpr int kBoxes = D / kBoxCols;       // boxes per tile row
  static constexpr int kQBox = kBq * kRowBytes;     // one box of the Q tile
  static constexpr int kKBox = kBk * kRowBytes;     // one box of a K/V tile
  static constexpr int kStage = kBoxes * kKBox;     // one K (or V) stage
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBoxes * kQBox;
  static constexpr int kV = kK + kStages * kStage;
  // Barriers, 8 bytes each: Q's, then per stage K full, V full, K empty,
  // V empty.
  static constexpr int kQBar = kV + kStages * kStage;
  static constexpr int kFullK = kQBar + 8;
  static constexpr int kFullV = kFullK + 8 * kStages;
  static constexpr int kEmptyK = kFullV + 8 * kStages;
  static constexpr int kEmptyV = kEmptyK + 8 * kStages;
  static constexpr int kAlloc = kEmptyV + 8 * kStages + 1024;  // + alignment
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of parity `parity` has completed. No trap
// guards the spin: with a trap anywhere in the kernel, ptxas compiles the
// consumers within the 168-register entry budget whatever setmaxnreg asks,
// and the 128-key tile's wgmmas then serialize or spill.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; the copy's bytes complete on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product's issue and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A wgmma shared-memory matrix descriptor for a tile of 128-byte rows in
// the 128-byte swizzle (8-row atoms of 1024 bytes from a 1024-aligned box).
// K-major operands (Q, K) step 8-row atoms by `sbo` = 1024; an MN-major
// operand (V) also steps from one 64-column box to the next by `lbo`.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;  // layout: 128-byte swizzle
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (+)= A B^T, m64n128k16: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// O += A B, m64n128k16: A from registers, B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += A B, m64n64k16: A from registers, B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The next stage of a ring of N, flipping the phase bit at each wrap.
template <int N>
__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == N) {
    stage = 0;
    phase ^= 1;
  }
}

// The producer: one thread of the producer warpgroup issues every copy of
// the block, the Q tile once and then each live tile's K and V into the
// next stage of their rings as the consumers free it.
template <int D>
__device__ __forceinline__ void produce(const Params& p, const KeyRange& range,
                                        int first, uint32_t base, int bi, int hi,
                                        int q0, const CUtensorMap* q_map,
                                        const CUtensorMap* k_map,
                                        const CUtensorMap* v_map) {
  using S = Bf16Smem<D>;
  prefetch_tensormap(q_map);
  prefetch_tensormap(k_map);
  prefetch_tensormap(v_map);
  mbar_expect_tx(base + S::kQBar, S::kBoxes * S::kQBox);
#pragma unroll
  for (int c = 0; c < S::kBoxes; ++c) {
    tma_load_4d(base + S::kQ + c * S::kQBox, q_map, base + S::kQBar, c * kBoxCols,
                hi, q0, bi);
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int j = first; j < range.tile_end; j = next_live(p, range, j + 1, kBk)) {
    const uint32_t off = stage * S::kStage;
    mbar_wait(base + S::kEmptyK + 8 * stage, phase ^ 1);
    mbar_expect_tx(base + S::kFullK + 8 * stage, S::kStage);
#pragma unroll
    for (int c = 0; c < S::kBoxes; ++c) {
      tma_load_4d(base + S::kK + off + c * S::kKBox, k_map, base + S::kFullK + 8 * stage,
                  c * kBoxCols, hi, j * kBk, bi);
    }
    mbar_wait(base + S::kEmptyV + 8 * stage, phase ^ 1);
    mbar_expect_tx(base + S::kFullV + 8 * stage, S::kStage);
#pragma unroll
    for (int c = 0; c < S::kBoxes; ++c) {
      tma_load_4d(base + S::kV + off + c * S::kKBox, v_map, base + S::kFullV + 8 * stage,
                  c * kBoxCols, hi, j * kBk, bi);
    }
    advance<S::kStages>(stage, phase);
  }
}

// S = Q K^T for this warpgroup's 64 rows against one K tile, over head-dim
// chunks of 16: chunk kc is 32 bytes into the 128-byte rows of box kc / 4.
template <int D>
__device__ __forceinline__ void issue_qk(float* s, uint32_t q_tile, uint32_t k_tile) {
  using S = Bf16Smem<D>;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const uint32_t col = (kc % 4) * 32;
    wgmma_ss_n128(s, smem_desc(q_tile + (kc / 4) * S::kQBox + col, 16, 1024),
                   smem_desc(k_tile + (kc / 4) * S::kKBox + col, 16, 1024), kc > 0);
  }
}

// O += P V over key chunks of 16: V's rows are keys, so B is MN-major and
// steps 16 rows (2048 bytes) per chunk and one box per 64 head-dim columns.
template <int D>
__device__ __forceinline__ void issue_pv(float* acc, const uint32_t (*pa)[4],
                                         uint32_t v_tile) {
  using S = Bf16Smem<D>;
#pragma unroll
  for (int kk = 0; kk < kBk / 16; ++kk) {
    const uint64_t vd = smem_desc(v_tile + kk * 16 * kRowBytes, S::kKBox, 1024);
    if constexpr (D == 128) {
      wgmma_rs_n128(acc, pa[kk], vd);
    } else {
      wgmma_rs_n64(acc, pa[kk], vd);
    }
  }
}

// The online softmax of one key tile for one warp's 16 rows: scale and mask
// the scores in s (the wgmma accumulator layout), fold them into the running
// max m and sum l, and leave P = exp2(s - m) in s. c0 / c1 come back as the
// correction of the earlier keys' accumulator rows.
__device__ __forceinline__ void online_softmax(float* s, const Params& p, int k0,
                                               int wq0, int row0, int t4,
                                               float scale_log2, float& m0,
                                               float& m1, float& l0, float& l1,
                                               float& c0, float& c1) {
  const int row1 = row0 + 8;
  // Tiles wholly visible to every row of this warp need no mask.
  const bool interior =
      k0 + kBk <= p.tk &&
      (!p.causal || p.k_off + k0 + kBk - 1 <= p.q_off + wq0) &&
      (p.window == 0 || p.k_off + k0 > p.q_off + wq0 + 15 - p.window);
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int n = 0; n < kBk / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row0 : row1;
      const int key = k0 + n * 8 + 2 * t4 + (e & 1);
      s[4 * n + e] = (interior || visible(p, row, key)) ? s[4 * n + e] * scale_log2
                                                       : kNegInf;
    }
    mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 2));

  c0 = exp2f(m0 - mx0);
  c1 = exp2f(m1 - mx1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < kBk / 8; ++n) {
    s[4 * n] = exp2f(s[4 * n] - mx0);
    s[4 * n + 1] = exp2f(s[4 * n + 1] - mx0);
    s[4 * n + 2] = exp2f(s[4 * n + 2] - mx1);
    s[4 * n + 3] = exp2f(s[4 * n + 3] - mx1);
    sum0 += s[4 * n] + s[4 * n + 1];
    sum1 += s[4 * n + 2] + s[4 * n + 3];
  }
  l0 = l0 * c0 + sum0;
  l1 = l1 * c1 + sum1;
  m0 = mx0;
  m1 = mx1;
}

// Rescale the accumulator rows by the softmax's correction, and round P to
// bf16 as P V's register A fragments: the S accumulators of column tiles 2kk
// and 2kk+1 are exactly the fragment of keys [16kk, 16kk+16).
template <int D>
__device__ __forceinline__ void rescale_and_pack(float* acc, uint32_t (*pa)[4],
                                                 const float* s, float c0, float c1) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[4 * dn] *= c0;
    acc[4 * dn + 1] *= c0;
    acc[4 * dn + 2] *= c1;
    acc[4 * dn + 3] *= c1;
  }
#pragma unroll
  for (int kk = 0; kk < kBk / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// A consumer: one warpgroup's 64 query rows of the block. Each warp owns 16
// rows; in the wgmma accumulator, element 4n + e of a thread is row
// g (+8 for e >= 2), column 8n + 2 * t4 + (e & 1), as in mma.sync's m16n8.
// The products of two tiles overlap the softmax: tile j's S = Q K^T is
// issued together with tile j-1's P V, and the softmax of tile j runs while
// that P V is still in flight.
template <int D, bool kPartial>
__device__ __forceinline__ void consume(const Params& p, const KeyRange& range,
                                        int first, uint32_t base, int bh, int bi,
                                        int hi, int q0) {
  using S = Bf16Smem<D>;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row group
  const int t4 = lane & 3;   // thread within the group
  const int wq0 = q0 + wg * 64 + warp * 16;  // this warp's first row
  const int row0 = wq0 + g;
  const int row1 = row0 + 8;
  // Scores are kept in the log2 domain: exp2(s*scale*log2e - m) is the
  // reference's exp(s*scale - m') up to rounding.
  const float scale_log2 = p.scale * kLog2e;

  float acc[D / 2];  // head-dim columns 8dn.. at acc[4 * dn + e]
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows row0 / row1
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums
  // Carry rows of this block's (b, h): row r of acc at carry[(cb + r) * D].
  const long long cb = static_cast<long long>(bh) * p.tq;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
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
        acc[4 * dn + 2 * half] = a.x;
        acc[4 * dn + 2 * half + 1] = a.y;
      }
      const float mv = to_log2(p.m[cb + row]);
      const float lv = t4 == 0 ? p.l[cb + row] : 0.f;
      if (half) { m1 = mv; l1 = lv; } else { m0 = mv; l0 = lv; }
    }
  }

  const uint32_t q_tile = base + S::kQ + wg * 64 * kRowBytes;  // this warpgroup's rows
  float s[kBk / 2];
  uint32_t pa[kBk / 16][4];
  float c0, c1;
  int stage = 0;
  uint32_t phase = 0;
  mbar_wait(base + S::kQBar, 0);

  // The first tile: S, then its softmax; its P V goes out with the next S.
  mbar_wait(base + S::kFullK + 8 * stage, phase);
  wgmma_fence();
  issue_qk<D>(s, q_tile, base + S::kK + stage * S::kStage);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<kBk / 2>(s);
  if (lane == 0) mbar_arrive(base + S::kEmptyK + 8 * stage);
  online_softmax(s, p, first * kBk, wq0, row0, t4, scale_log2, m0, m1, l0, l1, c0, c1);
  rescale_and_pack<D>(acc, pa, s, c0, c1);
  int pv_stage = stage;
  uint32_t pv_phase = phase;
  advance<S::kStages>(stage, phase);

  for (int j = next_live(p, range, first + 1, kBk); j < range.tile_end;
       j = next_live(p, range, j + 1, kBk)) {
    mbar_wait(base + S::kFullK + 8 * stage, phase);
    fence_regs<D / 2>(acc);
    fence_regs<kBk / 4>(&pa[0][0]);
    wgmma_fence();
    issue_qk<D>(s, q_tile, base + S::kK + stage * S::kStage);
    wgmma_commit();
    mbar_wait(base + S::kFullV + 8 * pv_stage, pv_phase);
    wgmma_fence();
    issue_pv<D>(acc, pa, base + S::kV + pv_stage * S::kStage);
    wgmma_commit();
    wgmma_wait<1>();  // this tile's S is done; the last tile's P V may not be
    fence_regs<kBk / 2>(s);
    if (lane == 0) mbar_arrive(base + S::kEmptyK + 8 * stage);
    online_softmax(s, p, j * kBk, wq0, row0, t4, scale_log2, m0, m1, l0, l1, c0, c1);
    wgmma_wait<0>();
    fence_regs<D / 2>(acc);
    fence_regs<kBk / 4>(&pa[0][0]);
    if (lane == 0) mbar_arrive(base + S::kEmptyV + 8 * pv_stage);
    rescale_and_pack<D>(acc, pa, s, c0, c1);
    pv_stage = stage;
    pv_phase = phase;
    advance<S::kStages>(stage, phase);
  }
  mbar_wait(base + S::kFullV + 8 * pv_stage, pv_phase);
  fence_regs<D / 2>(acc);
  fence_regs<kBk / 4>(&pa[0][0]);
  wgmma_fence();
  issue_pv<D>(acc, pa, base + S::kV + pv_stage * S::kStage);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<D / 2>(acc);
  fence_regs<kBk / 4>(&pa[0][0]);

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
            make_float2(acc[4 * dn + 2 * half], acc[4 * dn + 2 * half + 1]);
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
            pack_bf16(acc[4 * dn] / l0, acc[4 * dn + 1] / l0);
      }
      if (row1 < p.tq) {
        *reinterpret_cast<uint32_t*>(ob + row1 * p.o_st + col) =
            pack_bf16(acc[4 * dn + 2] / l1, acc[4 * dn + 3] / l1);
      }
    }
  }
}

template <int D, bool kPartial>
__global__ void __launch_bounds__(kThreadsBf16, 1)
    flash_fwd_bf16(const Params params, const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map) {
  using S = Bf16Smem<D>;
  const Params p = specialize<kPartial>(params);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int bh = blockIdx.y;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int q0 = qt * kBq;
  const KeyRange range = key_range(p, q0, kBq, kBk);
  const int first = next_live(p, range, range.tile_begin, kBk);
  if (kPartial && first >= range.tile_end) return;  // carry stays as it was

  if (threadIdx.x == 0) {
    mbar_init(base + S::kQBar, 1);
    for (int st = 0; st < S::kStages; ++st) {
      mbar_init(base + S::kFullK + 8 * st, 1);
      mbar_init(base + S::kFullV + 8 * st, 1);
      mbar_init(base + S::kEmptyK + 8 * st, kConsumers * 4);  // each consumer warp
      mbar_init(base + S::kEmptyV + 8 * st, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The roles split here and never meet again (setmaxnreg needs that). The
  // warpgroup index goes through a shuffle so that the compiler sees it is
  // the same across each warp.
  const int role = __shfl_sync(kFullMask, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == kConsumers) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      produce<D>(p, range, first, base, bi, hi, q0, &q_map, &k_map, &v_map);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<D, kPartial>(p, range, first, base, bh, bi, hi, q0);
  }
}

// ---------------------------------------------------------------- f32

constexpr int kBqF = 16;  // query rows per block, 8 threads per row
constexpr int kBkF = 32;  // keys per shared-memory tile
constexpr int kThreadsF32 = 128;

template <int D, bool kPartial>
__global__ void __launch_bounds__(kThreadsF32)
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

  for (int idx = threadIdx.x; idx < kBqF * D; idx += kThreadsF32) {
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
    for (int idx = threadIdx.x; idx < kBkF * D; idx += kThreadsF32) {
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

// ---------------------------------------------------------------- launch

// Returned by an entry point when the driver's cuTensorMapEncodeTiled is
// missing or refuses a q/k/v tensor (cudaError_t's own codes stay below).
constexpr int kTensorMapRefused = 20000;

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                   void*, const cuuint64_t*, const cuuint64_t*,
                                   const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(sym);
    }
  }
  return fn;
}

// A TMA map over a bf16 [b, t, h, d] tensor with strides in elements: dims
// (d, h, t, b) innermost first, boxes of 64 columns x `rows` rows of one
// (b, h), 128-byte swizzle, zeros past each extent.
bool make_map(CUtensorMap* map, const void* data, int b, int t, int h, int d,
              long long sb, long long st, long long sh, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(t), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(data),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool kPartial>
int launch_bf16(const Params& p, int b, cudaStream_t stream) {
  using S = Bf16Smem<D>;
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, p.q, b, p.tq, p.h, D, p.q_sb, p.q_st, p.q_sh, kBq) ||
      !make_map(&k_map, p.k, b, p.tk, p.h, D, p.k_sb, p.k_st, p.k_sh, kBk) ||
      !make_map(&v_map, p.v, b, p.tk, p.h, D, p.v_sb, p.v_st, p.v_sh, kBk)) {
    return kTensorMapRefused;
  }
  const auto kernel = flash_fwd_bf16<D, kPartial>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kAlloc);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.tq + kBq - 1) / kBq, b * p.h);
  kernel<<<grid, kThreadsBf16, S::kAlloc, stream>>>(p, q_map, k_map, v_map);
  return cudaGetLastError();
}

template <int D, bool kPartial>
int launch_f32(const Params& p, int b, cudaStream_t stream) {
  const dim3 grid((p.tq + kBqF - 1) / kBqF, b * p.h);
  flash_fwd_f32<D, kPartial><<<grid, kThreadsF32, 0, stream>>>(p);
  return cudaGetLastError();
}

template <bool kPartial>
int dispatch(const Params& p, int b, int d, int dtype_is_bf16, cudaStream_t s) {
  if (dtype_is_bf16 && d == 128) return launch_bf16<128, kPartial>(p, b, s);
  if (dtype_is_bf16 && d == 64) return launch_bf16<64, kPartial>(p, b, s);
  if (!dtype_is_bf16 && d == 128) return launch_f32<128, kPartial>(p, b, s);
  if (!dtype_is_bf16 && d == 64) return launch_f32<64, kPartial>(p, b, s);
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

// Each entry launches on `stream` and returns 0 when the kernel launched,
// else a cudaError_t code or kTensorMapRefused. dtype_is_bf16 selects bf16
// (1) or f32 (0); d is 64 or 128.

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
  return dispatch<false>(p, b, d, dtype_is_bf16, static_cast<cudaStream_t>(stream));
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
  return dispatch<true>(p, b, d, dtype_is_bf16, static_cast<cudaStream_t>(stream));
}

const char* flash_attention_error_string(int code) {
  if (code == kTensorMapRefused) {
    return "cuTensorMapEncodeTiled is missing or refused a q/k/v tensor map";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
