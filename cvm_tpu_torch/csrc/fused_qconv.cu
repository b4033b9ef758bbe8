// Fused W8A8 ConvBN for Hopper (sm_90a): quantize -> int8 x int8 implicit
// GEMM on wgmma with int32 accumulation -> f32 epilogue (acc*scale + bias,
// activation) -> bf16 / f32 out, or int8 out requantized into the
// consumer's lattice.
//
// Replaces the TPU kernel cvm_tpu/ops/pallas/fused_qconv.py::fused_qconv
// (bodies _kernel_1x1 / _kernel_3x3, helpers _quantize / _epilogue).
//
// What bounds it on this card. Per call of CenterNet config B (batch 8,
// stride-1 3x3 convs), operations at 1,979 int8 TOP/s against the bytes
// moved (input read once, output written once) at 3.35 TB/s: s3-s5 and the
// up blocks sit above the int8 ridge (compute-bound: 9*Cin MACs per output
// element), the stem, s2, up2 c2 and the head c1 below it (bytes-bound:
// wide maps, few channels). What the TPU kernel kept out of HBM (the s32
// accumulator, the f32 dequant/BN/activation chain, the requant) stays in
// registers and shared memory here too. Measured on the card, the limits
// are inside the SM: the producers' issue and quantize work per chunk, and
// the epilogue's per-element arithmetic (PERF.md, PR 3).
//
// Design, and what each point answers:
//   * Tile. A tile is 128 output pixels (16 rows x 8 columns of one image)
//     x BN output channels (BN = 64 or 128; wider Cout takes several
//     tiles). With 8-column tiles each 8-row core matrix of the wgmma A
//     operand is 8 consecutive pixels of one input row, and the next core
//     matrix along M is the next input row. A staged input chunk is laid
//     out [input row][K half][input col][16 channels], so a no-swizzle
//     K-major descriptor (LBO = one K half of a row, SBO = one input row)
//     addresses every 3x3 tap's shifted window by moving its start address
//     only: the 9 taps are 9 wgmma k-steps over one staged tile.
//   * Warp roles. Two consumer warpgroups (tile rows 0-7 and 8-15) issue
//     wgmma.mma_async m64nBNk32 .s32.s8.s8 from shared memory; two producer
//     warpgroups fill a ring of up to 4 stages (one 32-wide Cin chunk each:
//     the input tile with its halo and the chunk's weights for all taps),
//     with full/empty mbarriers between them. One block per SM walks tiles
//     blockIdx.x, + gridDim.x, ...; the ring runs on across tiles, so the
//     next tile's loads overlap this tile's epilogue.
//   * Weights are packed once per module (ops/cuda/fused_qconv.py
//     pack_qconv_weights) into the ring's image: one stage's weights are one
//     contiguous cp.async.bulk copy, completed on the stage's mbarrier.
//   * Inputs. int8 inputs (the chained c2 calls) go from HBM into the ring
//     by 16-byte cp.async (zero-filled outside the image: SAME padding);
//     bf16/f32 inputs land as they are by 16-byte cp.async into a
//     double-buffered raw area and are quantized once, in shared memory,
//     into the stage's int8 slab. Each input element is loaded and
//     quantized once per conv when Cout <= 128 (all the wide-map calls).
//   * Stem fold. For a 3x3 conv with 9*Cin <= 128 (the stem, Cin 12) the
//     taps fold into K: the producers build the 128-pixel im2col tile
//     (K = 9*Cin padded to a multiple of 32) and a tile takes 4 k-steps
//     instead of 9 x 32 mostly-zero ones.
//   * Deep calls. Where a call has fewer tiles than SMs (s5, up0), the
//     wrapper splits the Cin chunks over a cluster of 2-4 blocks along
//     grid.z; the int32 accumulators are summed through distributed shared
//     memory (exact) before the lead block's epilogue.
//   * Epilogue in registers (int32 -> f32 acc*scale + bias, the activation,
//     the requant), with the tile's scale and bias in shared memory and no
//     per-element branch; the tile is staged in shared memory and stored as
//     16-byte vectors (byte by byte only where a row is not 16-B aligned).
//   * Nothing falls back: the wrapper pads Cin on the device where a row is
//     not a whole number of copies (zero channels are exact) and raises on
//     what the kernel refuses.
//
// Known traps, handled where marked [T1]..[T4]:
//   [T1] jnp.round rounds half to even: use __float2int_rn, never roundf.
//   [T2] clip to [-127, 127] BEFORE the int8 cast.
//   [T3] the int32 sum stays below 2^31: |acc| <= 3*3*768*127^2 ~ 1.1e8.
//   [T4] silu is y*sigmoid(y) in f32 with the accurate expf (no fast-math);
//        acc*scale + bias is rounded as two operations (__fmul_rn,
//        __fadd_rn), as the plain version computes it; 1/(1+e) is the
//        approximate reciprocal refined by one Newton step, which is the
//        division's own fast path, so an int8 requant can differ from the
//        plain version's by one step only at a rounding boundary.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TH = 16;             // output tile rows
constexpr int TW = 8;              // output tile cols (one core matrix)
constexpr int CK = 32;             // Cin chunk = one wgmma k-step (int8)
constexpr int KF_MAX = 128;        // folded K (9*Cin padded) upper bound
constexpr int NCONS = 256;         // two consumer warpgroups
constexpr int NPROD = 256;         // two producer warpgroups
constexpr int NTHREADS = NCONS + NPROD;
constexpr int BAR_BYTES = 128;     // mbarriers at the start of shared memory
constexpr int SMEM_LIMIT = 232448;

enum XKind { X_F32 = 0, X_BF16 = 1, X_I8 = 2 };
enum OutKind { OUT_F32 = 0, OUT_BF16 = 1, OUT_I8 = 2 };
enum Act { ACT_NONE = 0, ACT_SILU = 1, ACT_RELU = 2 };

struct Args {
  const void* x;        // (B, H, W, cs) of kind xk: Cin channels, zero padded to cs
  const int8_t* w;      // packed weight image
  const float* scale;   // (Cout,)
  const float* bias;    // (Cout,)
  void* out;            // (B, H, W, Cout) of kind ok
  int B, H, W, Cin, cs, Cout, tiles_h, tiles_w, ntiles, nch, kf, xk, act, ok;
  float inv_sx, inv_s_out;
};

// Compile-time geometry of one instantiation; sizes in bytes.
template <int KS, int BN, bool FOLD>
struct Geo {
  static constexpr int HALO = KS / 2;
  static constexpr int IH = TH + 2 * HALO;
  static constexpr int IW = TW + 2 * HALO;
  static constexpr int TAPS = KS * KS;
  static constexpr int NU = IH * 2 * IW;                          // 16-B units of a chunk
  static constexpr int XB = FOLD ? TH * TW * KF_MAX : NU * 16;     // A slab
  static constexpr int WB = TAPS * 2 * BN * 16;                   // B slab (unfolded)
  static constexpr int STAGE = FOLD ? XB : XB + WB;
  static constexpr int XQ = 2944;                                 // fold: quantized tile
  static_assert(XB % 128 == 0 && WB % 128 == 0, "stage slabs stay 128-B aligned");
  static_assert(FOLD ? IH * IW * 16 <= XQ : true, "the folded tile fits");
};

// ---- PTX helpers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the barrier's phase of this parity completed. A wait of more
// than ~2^34 cycles (seconds) can only be a fault in the pipeline: trap, so
// that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1LL << 34)) __trap();
  } while (!done);
}

// One contiguous global -> shared copy, completed on an mbarrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// 16-byte async copy; src_bytes = 0 writes zeros (no global read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Generic-proxy writes to shared memory become visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ int ld_peer(uint32_t local_addr, uint32_t rank) {
  uint32_t remote;
  int v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local_addr), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(remote) : "memory");
  return v;
}

// wgmma shared-memory matrix descriptor, no swizzle (K-major core matrices
// of 8 rows x 16 bytes): LBO = byte step between the two 16-B K halves,
// SBO = byte step between 8-row groups.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 64) wgmma_n64(d, da, db);
  else wgmma_n128(d, da, db);
}

// Keep the compiler from moving accumulator accesses across wgmma fences.
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// ---- quantize / epilogue math -------------------------------------------

__device__ __forceinline__ int quantize(float v, float inv) {
  // [T2] clip first, [T1] then round half to even.
  return __float2int_rn(fminf(fmaxf(v * inv, -127.0f), 127.0f));
}

__device__ __forceinline__ uint32_t q4(float a, float b, float c, float d, float inv) {
  return (quantize(a, inv) & 0xFF) | ((quantize(b, inv) & 0xFF) << 8) |
         ((quantize(c, inv) & 0xFF) << 16) | (static_cast<uint32_t>(quantize(d, inv)) << 24);
}

__device__ __forceinline__ int load_q(const void* x, size_t i, int xk, float inv) {
  if (xk == X_I8) return static_cast<const int8_t*>(x)[i];  // already lattice points
  if (xk == X_BF16) return quantize(__bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]), inv);
  return quantize(static_cast<const float*>(x)[i], inv);
}

// Epilogue step 1, in registers: acc*scale + bias (rounded as two
// operations, as the plain version computes it) and the activation; the f32
// result replaces the int32 sum in place. Accumulator r of a thread sits at
// column 8*(r/4) + 2*(lane%4) + (r&1) of the tile.
template <int BN, int ACT>
__device__ __forceinline__ void apply_epilogue(int (&acc)[BN / 2], const float* sb, int q) {
#pragma unroll
  for (int r = 0; r < BN / 2; ++r) {
    const int col = 8 * (r / 4) + 2 * q + (r & 1);
    float y = __fadd_rn(__fmul_rn(static_cast<float>(acc[r]), sb[col]), sb[BN + col]);
    if (ACT == ACT_SILU) {
      // [T4] accurate expf. 1/d without the division's slow-path branch
      // (which keeps the compiler from interleaving elements): the
      // approximate reciprocal and one Newton step, 0 where d overflowed.
      const float d = 1.0f + expf(-y);
      float r;
      asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
      r = fmaf(r, fmaf(-d, r, 1.0f), r);
      y = y * (d < 3.0e38f ? r : 0.0f);
    } else if (ACT == ACT_RELU) {
      y = fmaxf(y, 0.0f);
    }
    acc[r] = __float_as_int(y);
  }
}

// Epilogue step 2: the tile, converted to the output kind, into the staging
// tile (row stride rs bytes). Accumulator r sits at row
// 16*warp + lane/4 + 8*((r>>1)&1) of its warpgroup's 64 pixels.
template <int BN, int OK>
__device__ __forceinline__ void stage_tile(const int (&acc)[BN / 2], uint8_t* stg, int rs,
                                           int m0, int q, float inv_s_out) {
  constexpr int E = OK == OUT_F32 ? 4 : OK == OUT_BF16 ? 2 : 1;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float y0 = __int_as_float(acc[4 * j + 2 * h]);
      const float y1 = __int_as_float(acc[4 * j + 2 * h + 1]);
      uint8_t* dst = stg + (m0 + 8 * h) * rs + (8 * j + 2 * q) * E;
      if (OK == OUT_F32) {
        *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
      } else if (OK == OUT_BF16) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y0, y1);
      } else {
        *reinterpret_cast<uint16_t*>(dst) =
            static_cast<uint16_t>((quantize(y0, inv_s_out) & 0xFF) |
                                  ((quantize(y1, inv_s_out) & 0xFF) << 8));
      }
    }
  }
}

// Shared-memory layout of one launch (bytes from the start): the mbarriers,
// two raw input buffers (bf16/f32 chunks, or the folded stem's tiles), the
// output staging tile, the tile's scale and bias, the folded weights, then
// the ring of `stages` stages.
struct Layout {
  int raw, raw_buf, xq, ko, epi, sb, wf, ring, stages, total;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <int KS, int BN, bool FOLD>
__host__ __device__ Layout make_layout(int xk, int ok, int cs) {
  using G = Geo<KS, BN, FOLD>;
  const int esz = xk == X_F32 ? 4 : xk == X_BF16 ? 2 : 1;
  const int eo = ok == OUT_F32 ? 4 : ok == OUT_BF16 ? 2 : 1;
  Layout l;
  l.raw_buf = FOLD ? round_up(G::IH * G::IW * cs * esz, 128)
                   : (xk == X_I8 ? 0 : G::NU * 16 * esz);
  l.raw = BAR_BYTES;
  l.xq = l.raw + 2 * l.raw_buf;
  l.ko = l.xq + (FOLD ? G::XQ : 0);
  l.epi = l.ko + (FOLD ? 2 * KF_MAX : 0);
  l.sb = l.epi + round_up(TH * TW * (BN * eo + 16), 128);
  l.wf = l.sb + 2 * BN * 4;
  l.ring = l.wf + (FOLD ? BN * KF_MAX : 0);
  l.stages = (SMEM_LIMIT - l.ring) / G::STAGE;
  if (l.stages > 4) l.stages = 4;
  l.total = l.ring + l.stages * G::STAGE;
  // A Cin split's partial sums reuse everything after the barriers.
  if (l.total < BAR_BYTES + NCONS * (BN / 2) * 4) l.total = BAR_BYTES + NCONS * (BN / 2) * 4;
  return l;
}

struct Tile {
  int b, h0, w0, nt;
};

__device__ __forceinline__ Tile tile_of(const Args& a, int t) {
  Tile r;
  r.nt = t % a.ntiles;
  t /= a.ntiles;
  r.w0 = (t % a.tiles_w) * TW;
  t /= a.tiles_w;
  r.h0 = (t % a.tiles_h) * TH;
  r.b = t / a.tiles_h;
  return r;
}

// Producer warpgroups: fill the ring, one item (a tile's Cin chunk, or a
// folded tile) per stage. Unfolded, thread 0 brings the chunk's weights by
// one bulk copy, counted on full[s] in bytes; every producer thread brings
// its share of the input by 16-B cp.async and arrives on full[s] once its
// copies (and, for bf16/f32, the quantize pass) are done. Item i's loads are
// in flight while item i-1 is quantized.
template <int KS, int BN, bool FOLD>
__device__ __forceinline__ void produce(const Args& a, const Layout& l, uint8_t* smem,
                                        uint32_t bar0, int c_begin, int nper, int items) {
  using G = Geo<KS, BN, FOLD>;
  const int S = l.stages;
  const int pt = threadIdx.x - NCONS;
  const int esz = a.xk == X_F32 ? 4 : a.xk == X_BF16 ? 2 : 1;
  uint8_t* ring = smem + l.ring;
  uint8_t* raw = smem + l.raw;
  if (FOLD && pt == 0) {  // the folded weights, once, on their own barrier
    const uint32_t wbar = bar0 + 8 * 2 * S;
    mbar_arrive_expect_tx(wbar, BN * a.kf);
    bulk_copy(smem_u32(smem + l.wf), a.w, BN * a.kf, wbar);
  }
  int16_t* ko = reinterpret_cast<int16_t*>(smem + l.ko);
  if (FOLD) {  // folded K index -> byte offset in the quantized tile (-1: padding)
    for (int k = pt; k < a.kf; k += NPROD) {
      const int tap = k / a.Cin;
      ko[k] = tap < 9 ? ((tap / 3) * G::IW + tap % 3) * a.cs + k - tap * a.Cin : -1;
    }
  }
  for (int i = 0; i <= items; ++i) {
    if (i < items) {
      const int s = i % S;
      if (i >= S) mbar_wait(bar0 + 8 * (S + s), ((i / S) + 1) & 1);
      const Tile t = tile_of(a, blockIdx.x + (i / nper) * gridDim.x);
      uint8_t* st = ring + s * G::STAGE;
      uint8_t* rb = raw + (i & 1) * l.raw_buf;
      if constexpr (FOLD) {
        // The tile with its halo as it lies in memory, 4-B pieces.
        const int per_px = a.cs * esz / 4;
        for (int u = pt; u < G::IH * G::IW * per_px; u += NPROD) {
          const int p = u / per_px, part = u - p * per_px;
          const int hh = t.h0 + p / G::IW - 1, ww = t.w0 + p % G::IW - 1;
          const bool inb = hh >= 0 && hh < a.H && ww >= 0 && ww < a.W;
          const size_t pix = (static_cast<size_t>(t.b) * a.H + (inb ? hh : 0)) * a.W + (inb ? ww : 0);
          cp_async4(smem_u32(rb + u * 4),
                    static_cast<const uint8_t*>(a.x) + pix * a.cs * esz + part * 4, inb ? 4 : 0);
        }
      } else {
        if (pt == 0) {
          const size_t c = static_cast<size_t>(t.nt) * a.nch + c_begin + i % nper;
          mbar_arrive_expect_tx(bar0 + 8 * s, G::WB);
          bulk_copy(smem_u32(st + G::XB), a.w + c * G::WB, G::WB, bar0 + 8 * s);
        }
        const int c0 = (c_begin + i % nper) * CK;
        for (int u = pt; u < G::NU; u += NPROD) {
          const int ix = u % G::IW, r = u / G::IW, kh = r & 1, iy = r >> 1;
          const int hh = t.h0 + iy - G::HALO, ww = t.w0 + ix - G::HALO;
          const int ch = c0 + kh * 16;
          const bool inb = hh >= 0 && hh < a.H && ww >= 0 && ww < a.W;
          const size_t pix = (static_cast<size_t>(t.b) * a.H + (inb ? hh : 0)) * a.W + (inb ? ww : 0);
          if (a.xk == X_I8) {
            const bool ok = inb && ch < a.cs;
            cp_async16(smem_u32(st + u * 16),
                       static_cast<const int8_t*>(a.x) + pix * a.cs + (ok ? ch : 0), ok ? 16 : 0);
          } else {
            const int per = 16 / esz;  // channels per 16-B piece
            for (int p = 0; p < esz; ++p) {
              const int cp = ch + p * per;
              const bool ok = inb && cp < a.cs;
              cp_async16(smem_u32(rb + u * 16 * esz + p * 16),
                         static_cast<const uint8_t*>(a.x) + (pix * a.cs + (ok ? cp : 0)) * esz,
                         ok ? 16 : 0);
            }
          }
        }
      }
      cp_async_commit();
    }
    if (i > 0) {
      const int j = i - 1, s = j % S;
      if (i < items) cp_async_wait<1>(); else cp_async_wait<0>();
      uint8_t* st = ring + s * G::STAGE;
      const uint8_t* rb = raw + (j & 1) * l.raw_buf;
      if constexpr (FOLD) {
        bar_sync(2, NPROD);  // every producer thread's copies of tile j landed
        int8_t* xq = reinterpret_cast<int8_t*>(smem + l.xq);
        const int n = G::IH * G::IW * a.cs;
        for (int e = pt; e < n; e += NPROD) {
          int v;
          if (a.xk == X_I8) v = reinterpret_cast<const int8_t*>(rb)[e];
          else if (a.xk == X_BF16) v = quantize(__bfloat162float(reinterpret_cast<const __nv_bfloat16*>(rb)[e]), a.inv_sx);
          else v = quantize(reinterpret_cast<const float*>(rb)[e], a.inv_sx);
          xq[e] = static_cast<int8_t>(v);
        }
        bar_sync(2, NPROD);  // xq complete; raw buffer j & 1 free for tile j + 2
        // im2col row of pixel m = pt % 128, one half of K per thread:
        // K = tap * Cin + ci.
        const int m = pt & 127, half = pt >> 7, nkc = a.kf / 32;
        const int8_t* px = xq + ((m / TW) * G::IW + m % TW) * a.cs;
        uint8_t* A = st + (m / 8) * (a.kf * 8) + (m % 8) * 16;
        for (int kc = half * nkc; kc < (half + 1) * nkc; ++kc) {
          uint32_t w4[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t word = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int o = ko[kc * 16 + q * 4 + e];
              const int v = o >= 0 ? px[o] : 0;
              word |= static_cast<uint32_t>(v & 0xFF) << (8 * e);
            }
            w4[q] = word;
          }
          *reinterpret_cast<uint4*>(A + kc * 128) = make_uint4(w4[0], w4[1], w4[2], w4[3]);
        }
      } else if (a.xk != X_I8) {
        bar_sync(2, NPROD);  // every producer thread's copies of chunk j landed
        for (int u = pt; u < G::NU; u += NPROD) {
          uint32_t w4[4];
          if (a.xk == X_BF16) {
            const uint4 lo = *reinterpret_cast<const uint4*>(rb + u * 32);
            const uint4 hi = *reinterpret_cast<const uint4*>(rb + u * 32 + 16);
            const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float2 f0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v[2 * k]));
              const float2 f1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v[2 * k + 1]));
              w4[k] = q4(f0.x, f0.y, f1.x, f1.y, a.inv_sx);
            }
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float4 f = *reinterpret_cast<const float4*>(rb + u * 64 + k * 16);
              w4[k] = q4(f.x, f.y, f.z, f.w, a.inv_sx);
            }
          }
          *reinterpret_cast<uint4*>(st + u * 16) = make_uint4(w4[0], w4[1], w4[2], w4[3]);
        }
        bar_sync(2, NPROD);  // raw buffer j & 1 free for chunk j + 2
      }
      fence_proxy_async();
      mbar_arrive(bar0 + 8 * s);
    }
  }
}

// One block per SM walks tiles blockIdx.x, + gridDim.x, ...; its ring runs on
// across tiles, so the producer loads the next tile while the consumers run
// the epilogue. With a Cin split (gridDim.z > 1) each block takes one tile.
template <int KS, int BN, bool FOLD>
__global__ void __launch_bounds__(NTHREADS, 1) fused_qconv_kernel(const __grid_constant__ Args a) {
  using G = Geo<KS, BN, FOLD>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const Layout l = make_layout<KS, BN, FOLD>(a.xk, a.ok, a.cs);
  const int S = l.stages;
  const uint32_t bar0 = smem_u32(smem);  // full[s] at +8s, empty[s] at +8(S+s), wbar after
  const int ksplit = gridDim.z;
  const int c_begin = FOLD ? 0 : blockIdx.z * a.nch / ksplit;
  const int nper = FOLD ? 1 : (blockIdx.z + 1) * a.nch / ksplit - c_begin;
  const int total = a.B * a.tiles_h * a.tiles_w * a.ntiles;
  const int mine = static_cast<int>(blockIdx.x) < total
                       ? (total - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1
                       : 0;
  const int items = mine * nper;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bar0 + 8 * s, FOLD ? NPROD : NPROD + 1);  // producer threads (+ weights)
      mbar_init(bar0 + 8 * (S + s), NCONS);        // every consumer thread
    }
    mbar_init(bar0 + 8 * 2 * S, 1);                // folded weights
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NCONS) {  // ---- producer warpgroups
    produce<KS, BN, FOLD>(a, l, smem, bar0, c_begin, nper, items);
    if (ksplit > 1) {
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // ---- consumer warpgroups: wg 0 computes tile rows 0-7, wg 1 rows 8-15.
  const int ct = threadIdx.x, wg = ct >> 7;
  const int esz = a.ok == OUT_F32 ? 4 : a.ok == OUT_BF16 ? 2 : 1;
  const int rs = BN * esz + 16;  // staging row stride (bytes)
  uint8_t* stg = smem + l.epi;
  const int warp = (ct & 127) >> 5, q = ct & 3, g = (ct & 31) >> 2;
  if (FOLD) mbar_wait(bar0 + 8 * 2 * S, 0);
  const uint32_t wf = smem_u32(smem + l.wf);
  int it = 0;
  float* sb = reinterpret_cast<float*>(smem + l.sb);
  for (int k = 0; k < mine; ++k) {
    const Tile t = tile_of(a, blockIdx.x + k * gridDim.x);
    const int n0 = t.nt * BN;
    // The tile's scale and bias, read by the epilogue after its first
    // barrier (the previous tile's epilogue stopped reading them before its
    // second one).
    if (ct < BN) {
      sb[ct] = n0 + ct < a.Cout ? a.scale[n0 + ct] : 0.0f;
      sb[BN + ct] = n0 + ct < a.Cout ? a.bias[n0 + ct] : 0.0f;
    }
    int acc[BN / 2];
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[r] = 0;
    for (int c = 0; c < nper; ++c, ++it) {
      const int s = it % S;
      mbar_wait(bar0 + 8 * s, (it / S) & 1);
      const uint32_t st = smem_u32(smem + l.ring + s * G::STAGE);
      fence_acc(acc);
      wgmma_fence();
      if constexpr (FOLD) {
        for (int j = 0; j < a.kf / 32; ++j)
          wgmma<BN>(acc, make_desc(st + wg * 64 * a.kf + j * 256, 128, a.kf * 8),
                    make_desc(wf + j * 2 * BN * 16, BN * 16, 128));
      } else {
#pragma unroll
        for (int tap = 0; tap < G::TAPS; ++tap) {
          const int dy = tap / KS, dx = tap % KS;
          wgmma<BN>(acc,
                    make_desc(st + (wg * 8 + dy) * (2 * G::IW * 16) + dx * 16, G::IW * 16,
                              2 * G::IW * 16),
                    make_desc(st + G::XB + tap * 2 * BN * 16, BN * 16, 128));
        }
      }
      wgmma_commit();
      fence_acc(acc);
      // Release the stage as soon as its products are done: the producer
      // quantizes item i-1 only after it has waited for item i's stage, so a
      // release that waited for the next item would deadlock a 2-stage ring.
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(bar0 + 8 * (S + s));
    }

    if (ksplit > 1) {  // sum the cluster's partial accumulators into rank 0
      bar_sync(1, NCONS);  // both warpgroups are done reading the ring
      const uint32_t rank = cluster_rank();
      int* red = reinterpret_cast<int*>(smem + BAR_BYTES);
      if (rank != 0) {
#pragma unroll
        for (int r = 0; r < BN / 2; ++r) red[r * NCONS + ct] = acc[r];
      }
      cluster_sync();
      if (rank == 0) {
        const uint32_t base = smem_u32(red);
        for (int p = 1; p < ksplit; ++p) {
#pragma unroll
          for (int r = 0; r < BN / 2; ++r) acc[r] += ld_peer(base + (r * NCONS + ct) * 4, p);
        }
      }
      cluster_sync();  // peers keep their shared memory until rank 0 has read it
      if (rank != 0) return;
    }

    // Epilogue: in registers, then through the staging tile to 16-B stores.
    bar_sync(1, NCONS);  // the previous tile's stores have read the staging tile
    if (a.act == ACT_SILU) apply_epilogue<BN, ACT_SILU>(acc, sb, q);
    else if (a.act == ACT_RELU) apply_epilogue<BN, ACT_RELU>(acc, sb, q);
    else apply_epilogue<BN, ACT_NONE>(acc, sb, q);
    const int m0 = 64 * wg + 16 * warp + g;
    if (a.ok == OUT_BF16) stage_tile<BN, OUT_BF16>(acc, stg, rs, m0, q, a.inv_s_out);
    else if (a.ok == OUT_I8) stage_tile<BN, OUT_I8>(acc, stg, rs, m0, q, a.inv_s_out);
    else stage_tile<BN, OUT_F32>(acc, stg, rs, m0, q, a.inv_s_out);
    bar_sync(1, NCONS);
    const int vsh = 31 - __clz(BN * esz / 16);  // log2 of the 16-B vectors per row
    const int per_vec = 16 / esz;               // channels per vector
    const bool aligned = (a.Cout * esz) % 16 == 0;
    for (int idx = ct; idx < (TH * TW) << vsh; idx += NCONS) {
      const int m = idx >> vsh, v = idx & ((1 << vsh) - 1);
      const int oy = t.h0 + m / TW, ox = t.w0 + m % TW;
      const int co0 = n0 + v * per_vec;
      if (oy >= a.H || ox >= a.W || co0 >= a.Cout) continue;
      uint8_t* gp = static_cast<uint8_t*>(a.out) +
                    (((static_cast<size_t>(t.b) * a.H + oy) * a.W + ox) * a.Cout + co0) * esz;
      const uint8_t* sp = stg + m * rs + v * 16;
      if (aligned && co0 + per_vec <= a.Cout) {
        *reinterpret_cast<uint4*>(gp) = *reinterpret_cast<const uint4*>(sp);
      } else {
        const int nb = min(16, (a.Cout - co0) * esz);
        for (int e = 0; e < nb; ++e) gp[e] = sp[e];
      }
    }
  }
}

template <int KS, int BN, bool FOLD>
int launch(const Args& a, int ksplit, cudaStream_t stream) {
  static int smem_set = 0;  // the largest dynamic shared memory granted so far
  static int sms = 0;
  auto kern = fused_qconv_kernel<KS, BN, FOLD>;
  const Layout l = make_layout<KS, BN, FOLD>(a.xk, a.ok, a.cs);
  if (l.stages < 2 || 8 * (2 * l.stages + 1) > BAR_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  if (l.total > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, l.total);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = l.total;
  }
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int total = a.B * a.tiles_h * a.tiles_w * a.ntiles;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ksplit > 1 || total < sms ? total : sms), 1,
                     static_cast<unsigned>(ksplit));
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = l.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = static_cast<unsigned>(ksplit);
  cfg.attrs = attr;
  cfg.numAttrs = ksplit > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// Plain C interface (bound with ctypes). x (B,H,W,cs) NHWC of kind x_kind,
// contiguous and 16-B aligned, its Cin channels zero padded to cs (cs*size
// a multiple of 4 folded, of 16 unfolded); wpack the packed weight image of
// pack_qconv_weights(w (ks,ks,Cin,Cout)) for tile width bn and fold/kf;
// scale/bias (Cout,) f32; out (B,H,W,Cout) of kind out_kind. ksplit splits
// the Cin chunks over a cluster of that many blocks. Returns a cudaError_t
// (0 = launched).
extern "C" int fused_qconv_launch(const void* x, const void* wpack, const void* scale,
                                  const void* bias, void* out, int B, int H, int W, int Cin,
                                  int cs, int Cout, int ks, int x_kind, float inv_sx, int act,
                                  int out_kind, float inv_s_out, int bn, int fold, int kf,
                                  int ksplit, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if ((ks != 1 && ks != 3) || (bn != 64 && bn != 128) || x_kind < 0 || x_kind > 2 ||
      out_kind < 0 || out_kind > 2 || act < 0 || act > 2 || B < 1 || H < 1 || W < 1 ||
      Cin < 1 || cs < Cin || Cout < 1 || ksplit < 1 || ksplit > 4)
    return bad;
  Args a;
  a.x = x;
  a.w = static_cast<const int8_t*>(wpack);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.B = B;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.cs = cs;
  a.Cout = Cout;
  a.tiles_h = (H + TH - 1) / TH;
  a.tiles_w = (W + TW - 1) / TW;
  a.ntiles = (Cout + bn - 1) / bn;
  a.nch = (Cin + CK - 1) / CK;
  a.kf = kf;
  a.xk = x_kind;
  a.act = act;
  a.ok = out_kind;
  a.inv_sx = inv_sx;
  a.inv_s_out = inv_s_out;
  const int esz = x_kind == X_F32 ? 4 : x_kind == X_BF16 ? 2 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fold) {
    if (ks != 3 || ksplit != 1 || a.ntiles != 1 || kf % 32 != 0 || kf > KF_MAX ||
        9 * Cin > kf || cs > 16 || (cs * esz) % 4 != 0)
      return bad;
    return bn == 64 ? launch<3, 64, true>(a, 1, s) : launch<3, 128, true>(a, 1, s);
  }
  if ((cs * esz) % 16 != 0 || cs > a.nch * CK || ksplit > a.nch) return bad;
  if (ks == 3) return bn == 64 ? launch<3, 64, false>(a, ksplit, s) : launch<3, 128, false>(a, ksplit, s);
  return bn == 64 ? launch<1, 64, false>(a, ksplit, s) : launch<1, 128, false>(a, ksplit, s);
}
