// Fused multi-head self-attention over the fused QKV projection, for
// sm_90a, on Hopper's own instructions (wgmma, TMA, mbarriers, warp
// specialization): kernel K2 with its emission K2e, kernel K4 with its
// emission K4e, kernel K5, kernel K6 with its causal modes K6c and K6ca
// and its banded mode K6w, kernel K7, and the context-parallel K8a and K8b
// of the PyTorch port, as nine mask modes of one kernel and two operand
// layouts; and K2's int8 scores K2i8, with or without emission, as a
// kernel of its own on the same producer, ring and epilogues
// (attn90_i8_kernel, below). Every attention kernel of the port is here.
//
// Replaces (embeddings_tpu/ops/attention.py, the Pallas TPU kernels):
//   mode 0, K2: _attn_kernel (its bf16 branch), behind fused_attention();
//               with emission, K2e: _attn_kernel with _emit_int8_rows,
//               behind fused_attention(emit_quantized=);
//   mode 1, K4: _attn_kernel_segmented, behind fused_attention_segmented();
//               with emission, K4e: _attn_kernel_segmented with
//               _emit_int8_rows, behind fused_attention_segmented(
//               emit_quantized=);
//   mode 2, K5: _attn_kernel_seg_window, behind
//               fused_attention_segmented_blockskip();
//   mode 3, K7: _attn_kernel_bias, behind fused_attention_bias() (MPNet's
//               relative-position bias, jina's ALiBi on short rows);
//   modes 4, 5, K6: _attn_kernel_stream in its plain and ALiBi modes,
//               behind fused_attention_stream();
//   mode 6, K6w: _attn_kernel_stream in its span + window (banded) mode,
//               behind fused_attention_window() (ModernBERT's local
//               layers);
//   mode 7, K6c: _attn_kernel_stream in its causal mode, behind
//               fused_attention_stream(causal=True);
//   mode 8, K6ca: _attn_kernel_stream with causal and ALiBi together,
//               behind fused_attention_stream(causal=True, alibi_slopes=);
//   mode 4 in the CP layout, K8a and K8b: _attn_kernel_cp and
//               _attn_kernel_cp_stream, behind fused_attention_cp() and
//               fused_attention_cp_stream() (context parallelism; the two
//               TPU kernels compute the same sums, the second over key
//               blocks, and this kernel streams key tiles in both);
//   K2i8: _attn_kernel's int8_scores branch (with _emit_int8_rows for
//               K2i8 with emission), behind fused_attention(int8_scores=);
//   mode 7 at MLA's widths (attn_sm90_kernel_mla): no TPU kernel, the
//               port's own, behind fused_attention_stream(causal=True,
//               dv=) (DeepSeek-V2's multi-head latent attention).
//
// For each sequence b, head h and query i, reading q, k and v as column
// slices of the fused qkv [B*L, 3E] (q at h*D, k at E + h*D, v at 2E +
// h*D), with d = q . k_j accumulated in f32 (the CP layout: below):
//   mode 0: s = clamp(bf16(q * s2) . k_j, -100, hi) (q pre-scaled and
//           rounded, the TPU's K2 rounding);
//   mode 1: s = clamp(d * s2, -100, hi), key j valid iff seg[b, i] ==
//           seg[b, j] and seg[b, j] >= 0 (token-packed rows; a pad query
//           row, seg -1, sees no key);
//   mode 2: mode 1 over the key tiles kbs[b, qb] .. min(kbs + W - 1,
//           kbe[b, qb]) of 128-row query block qb only (block_ranges; the
//           128-key tiles are the TPU's BQ blocks): the others are never
//           loaded, tiles past the cap W are dropped, and an all-pad
//           query block (kbe < kbs) sees no key; hi sized to min(W*128,
//           L) keys;
//   mode 3: s = clamp(d * s2 + bias[h, i, j], -100, hi) (bias f32 [H, L,
//           L], log2-scaled; the clamp after the add);
//   mode 4: s = clamp(d * s2, -100, hi);
//   mode 5: s = clamp(d * s2 - slope[h] * (f32(|i - j|) * log2(e)), -100,
//           hi) (jina-bert-v2's ALiBi from positions);
//   mode 6: mode 4's score, key j also dropped where |i - j| > W (W =
//           window // 2), over the 128-key tiles the band of the block's
//           query rows meets inside len[b] only (band_tiles);
//   mode 7: mode 4's score, key j also dropped where j > i;
//   mode 8: mode 5's score with mode 7's mask;
//   key j valid iff j < len[b] (and j <= i in modes 7, 8; j < L in mode 1)
//   p_j = bf16(exp2(s)) if valid else 0
//   out = (sum_j p_j v_j) * (1 / max(sum_j p_j, 1e-30))  (f32 sums)
// written as bf16 to out [B*L, E] at column h*D. s2 = log2(e)/sqrt(D);
// hi = 127 - ceil(log2 L), sized to all L keys. The multiply-adds the
// plain versions round separately are written __fmul_rn / __fsub_rn, so
// nvcc's FMA contraction cannot change a score. There is no max
// subtraction (the clamp keeps exp2 and the sums finite at any length),
// so a key tile only adds into the output and the row sum: no running
// max, no rescale of the output. Whole key tiles past len[b], or past a
// causal block's last query row, add exact zeros and are skipped; ALiBi
// tiles far from the diagonal add exp2(-100) and are not. A len-0 row
// gives exactly 0; query rows >= L are never written.
//
// The CP operand layout (K8a, K8b; mode 4's score and prefix mask): a
// shard's Lq = Lc local query rows a sequence against the L all-gathered
// keys. q [B*Lc, E] has any row stride ldq % 8 == 0 (a column slice of the
// local fused projection [B*Lc, 3E] is read in place, ldq = 3E; a rotated
// q has ldq = E), kv [B*L, 2E] holds k at h*D and v at E + h*D, out is
// [B*Lc, E]; hi is sized to the L gathered keys, not to Lc.
//
// The MLA layout (mode 7 only): q and k heads D = 192 wide (128 without
// position, 64 rotated), v heads DV = 128 wide, read from one qkv [B*L,
// H*(2D + DV)] (q at h*D, k at H*D + h*D, v at 2H*D + h*DV), the context
// written [B*L, H*DV]; s2 is the softmax scale (DeepSeek-V2-Lite's
// 192^-0.5 * mscale^2) times log2(e), passed in. A Q or K tile row is
// three 64-column boxes, a V tile row two; the ring is two stages deep
// (210 KB of shared memory a block). At B=8, L=4,096, H=16 the causal
// half's products are ~687 GFLOP on ~671 MB (qkv in, context out): bound
// by the tensor cores (0.69 ms at 989 TFLOP/s).
//
// Emission (modes 0 and 1, K2e and K4e; the TPU's _emit_int8_rows): each
// context row is also ("both") or instead ("only") written as symmetric
// int8 over all E = H*D columns: so = max(max_e |ctx|, 1e-30) * (1/127),
// o8 = rint(ctx * (1/so)), the reciprocal taken once a row
// (int8_rows.cuh). "both" quantizes the bf16 context it writes, "only"
// the f32 context (written to no bf16 output).
//
// What bounds it on the H100: K6 at Qwen2's B=4, L=4,096, H=12, D=128
// does ~206 GFLOP of products on ~201 MB (qkv in, context out): bound by
// the tensor cores (0.21 ms at 989 TFLOP/s, twice that without the causal
// half-skip). At D=64 (jina, ModernBERT, B=4, L=8,192) the products are
// ~825 GFLOP and the B*H*L^2 = 3.2 G exp2 alone take 0.77 ms on the
// SFUs (16 a clock per SM), close to the products' 0.83 ms: the score
// pass has to run beside the products, not after them. K2 at bge's B=128,
// L=256, D=64 moves the same ~201 MB for ~26 GFLOP: bound by bytes
// (0.06 ms); K2e "only" there reads the 151 MB of qkv and writes 25 MB of
// codes (0.05 ms), K4e at 256 packed rows of 128 the same. K7 at jina's
// B=32, L=1,024 does ~103 GFLOP and 403 M exp2 (both ~0.10 ms) on ~201 MB
// of qkv and context plus the 50.3 MB bias (0.075 ms of bytes): every
// batch row reads the whole bias again, which is about the size of L2.
// K4 at 256 packed rows of 128 moves K2's ~201 MB for ~26 GFLOP: bound
// by bytes (0.06 ms); a row of 128 is one key tile, so a block of one
// head does one tile's work between its prologue and its epilogue. K5 at
// 32 packed rows of 1,024 (W=3) moves the same ~201 MB for ~19 GFLOP of
// its same-segment pairs and ~151 M exp2 (0.036 ms on the SFUs): bound by
// bytes (0.06 ms), at most 3 key tiles a head. K6w at ModernBERT's B=32,
// L=1,024 and B=4, L=8,192 (window 128: W=64) moves the same ~201 MB for
// ~13 GFLOP of its band's pairs: bound by bytes (0.06 ms); a 128-row query
// block walks 3 key tiles a head, and every one of them needs the band
// mask. K2i8 at bge's shape moves
// the same ~201 MB for ~26 G int8 operations (0.013 ms at 1,979 TOP/s):
// bound by bytes (0.06 ms; "only" 0.053), but every q, k and v element is
// quantized in the kernel and each score takes an exp2 and two roundings,
// so its arithmetic, not its products, sets its time. K8a
// at bge's CP shard (B=16, Lc=256, L=512) reads q, the gathered k and v
// and writes the context, ~38 MB, for ~6.4 GFLOP: bound by bytes (0.011
// ms). K8b at nomic's shard (B=4, Lc=512, L=2,048) moves ~32 MB for ~12.9
// GFLOP: bound by the tensor cores (0.013 ms); its 4 x 4 x 12 = 192
// (query tile, head, sequence) blocks fill 132 SMs in 1.45 waves.
//
// The design:
// - one block per (128 query rows, head, sequence): a producer
//   warpgroup, one thread of which issues the TMA copies, and two
//   consumer warpgroups of 64 query rows each (one where L <= 64, K2's
//   short rows: chosen on the host); setmaxnreg gives the producer's
//   registers to the consumers (24 / 240);
// - the Q tile comes once by TMA; K and V tiles of 128 keys come through
//   a ring (2 stages at D=128, 3 below) with separate full / empty
//   mbarriers for K and V, so a stage's K is released as soon as its
//   scores are done and its V once its product is. TMA reads 3-D boxes of
//   qkv viewed as [B, L, 3E]: a box never reads another sequence's rows
//   (rows past L read as zeros), and lands 128-byte swizzled (64-byte at
//   D=32, whose rows are 64 bytes); at D=128 a tile row is two 64-column
//   boxes. 128-key tiles: the S accumulator (64 f32 a thread) and the
//   bf16 probabilities (32 registers) fit beside D=128's output (64) in
//   the consumers' 240 registers, and half as many tiles halve the
//   per-tile barrier and issue overhead of 64-key tiles;
// - mode 0 scales and re-rounds each warpgroup's Q rows once, in shared
//   memory, before the first product;
// - S = Q . K^T on wgmma m64n128k16 with both operands in shared memory
//   (K-major), f32 accumulators in registers;
// - the score pass runs in registers, in place on S: scale or ALiBi,
//   clamp, exp2 (one MUFU.EX2), the key mask only on tiles that need it
//   (the tile holding len[b], the diagonal tiles, every tile of mode 1),
//   bf16 rounding and the row sum of the rounded p per thread (a quad
//   shuffle at the end); with
//   ALiBi at D <= 64, whose score pass bounds the kernel, the tensor
//   cores take the row sums instead (P times a ones tile, ones_sum).
//   wgmma's m64nN f32 accumulator layout is its k16 A-fragment layout, so
//   S packs into the A operand of O += P . V in place (wgmma with A in
//   registers, m64n{D}k16), with V read from shared memory as the MN-major
//   B operand (the transpose bit): P never touches shared memory;
// - in each iteration a warpgroup issues the scores of tile t and the
//   product of tile t - 1 together and runs tile t's score pass while the
//   product runs; the two warpgroups take turns issuing (named barriers),
//   so one's exp2 pass also runs beside the other's products;
// - ptxas serializes every wgmma of a kernel (a wait after each; its
//   C75xx notes under -Xptxas -v) if a wgmma's registers are written
//   between its fence and its wait, or it sits under a branch it cannot
//   prove warp-uniform. So: the warpgroup index and len[b] are broadcast
//   with a shuffle; the first and last tiles are peeled, so the loop
//   issues both products unconditionally; the A fragments are written by
//   the conversion itself after the product that reads them completes
//   (register moves into them serialize); the descriptors are advanced
//   from per-kernel bases;
// - causal blocks are issued longest first (the query-block index runs
//   backwards), so the short blocks fill the tail;
// - mode 1's segment ids come with each K tile (a 128-key TMA box of seg
//   [B, L], counted in the K stage's transaction bytes; keys past L read
//   as 0 and are masked by position), its query rows' ids once a block;
//   K4 (mode 1 without emission) runs every head of its (query tile,
//   sequence) in one block, as the emission does (below; SEG_ALL_HEADS),
//   so a block's prologue, its query rows' ids and its row tail serve 12
//   heads of one-tile rows, not one;
// - mode 2 is mode 1 with the block's key-tile range read from kbs / kbe
//   and broadcast from lane 0 (as len is, so its loop bound stays
//   provably uniform and the first and last tiles stay peeled); the
//   producer loads only those tiles, and an empty range (an all-pad query
//   block) runs no tile and writes zeros. It runs every head of a 128-row
//   block in one block too (WIN_ALL_HEADS; 0.137-0.140 ms against
//   0.140-0.142 a block per head at 32 packed rows of 1,024, W=3,
//   tools/attention_ab.py, H100 at 700 W);
// - mode 6 (K6w) takes mode 2's walk with its key-tile range computed from
//   q0, W and len[b] (band_tiles; no tables), and mode 4's score with a
//   lower and an upper key limit a row in the score pass. BAND_ALL_HEADS
//   and BAND_PER_WG choose how its blocks run (see there);
// - the CP layout (K8a, K8b) is a template parameter (CP = 1), not a
//   branch: q comes by TMA from its own 3-D map [B, Lc, E] of row stride
//   ldq (rows past Lc read as zeros), k and v from a map of kv [B, L, 2E];
//   the grid's query tiles cover Lc, the key tiles len[b] of L. K8b's
//   1.45 waves at nomic's shard were not split: each block's key tiles
//   split over a cluster of two, rank 1 handing its f32 partial sums to
//   rank 0 through distributed shared memory, took 0.049-0.050 ms against
//   0.047-0.048 unsplit (tools/attention_ab.py, H100 at 700 W);
// - mode 3's bias comes by TMA too, as a third ring (64-row x 32-key f32
//   boxes, 128-byte swizzled: 64 KB a 128 x 128 tile, two stages at D <=
//   64 beside a two-stage K/V ring, one at D=128), each thread reading
//   its pairs of bias values from shared memory in the score pass. A bias
//   larger than half of L2 runs its blocks with the sequence index
//   fastest (grid (B, q-blocks, H)), so the B blocks that read one
//   (query block, head) tile of it run together and it comes from HBM
//   about once, not once a sequence (jina's 50.3 MB at L=1,024); a
//   smaller one stays in L2 across the batch, and the query block
//   fastest keeps each sequence's K/V tiles in L2 across its query
//   blocks instead (MPNet's 3.1 MB at L=256; both orders timed with
//   tools/attention_ab.py);
// - the epilogue scales the f32 output rows by 1 / max(sum, 1e-30) and
//   stores bf16 pairs straight from registers, guarded by L;
// - emission (EMIT != 0) needs each row's absmax over every head, and a
//   block of the other modes holds one head. So an emitting block owns a
//   (query tile, sequence) and runs all H heads in turn, as the TPU
//   kernel does: the producer keeps the ring full across head boundaries
//   (Q double-buffered: head h + 1's Q lands while head h runs), and after
//   each head every consumer writes its rows of that head to global
//   memory (bf16 into out for "both", f32 into a scratch [B*L, E] for
//   "only", both still in L2 when they are read back) and keeps its two
//   rows' running absmax in registers (a quad holds a row: a quad
//   shuffle ends the max). After the last head a warpgroup syncs on its
//   named barrier, re-reads its 64 x E rows (16-byte loads, a 128-byte
//   line or 16 bf16 a thread), writes the codes with 16-byte stores and
//   the scales, and drops each scratch line from L2 unwritten
//   (discard.global.L2): nothing reads it again, so it never costs a
//   write to HBM. No thread-block cluster and no H cap: grid B * q-tiles
//   (256 blocks at bge's B=128, L=256 and at 256 packed rows of 128),
//   the last sequence's blocks first: the Engine's batches come sorted
//   by length, ascending (all-pad rows, which have no key tile, last), so
//   their longest rows start first and the short ones fill the tail, as
//   the causal modes start their longest blocks first.
//
// K2i8 (attn90_i8_kernel; the TPU's int8-scores branch, prefix mask): per
// head, q and k quantize per row and v per column over all L rows (pads
// included), floor 1e-30, the reciprocal taken once and then multiplied
// (quantize_sym's order); s = (f32(s32) * (sq * s2)) * sk, keys j >=
// len[b] at -1e30; m = the row max; p8 = rint(exp2(s - m + log2 127)) in
// [0, 127]; out = (f32(p8 . v8) * sv) * (127 / max(f32(127 * sum p8),
// 1)). A len-0 row has m = -1e30 and p8 = 127 on every key (the mean of
// v), as on the TPU. m and v's column scales need the whole row before
// the first p8. The design (times at bge's B=128, L=256 from
// tools/attention_ab.py, H100 at 700 W):
// - a block owns a (query tile, sequence) and runs every head, the ring
//   running on across heads, as the emitting blocks do (no cluster);
// - the producer brings bf16 Q, K and V tiles by TMA as in the other
//   modes, and the consumers quantize them into int8 operand tiles in
//   shared memory (the unswizzled core-matrix layout, cm_off): no
//   quantize launch and no int8 copy in device memory. The two
//   warpgroups each quantize half of a K or V tile (0.435-0.450 ms
//   against 0.515 each warpgroup the whole tile);
// - pass A scores each K tile (to len; every tile of a len-0 row) on s8
//   wgmma (m64n128k32) for the row max, and reads every V tile of the row
//   for v's column absmax; pass B takes p8 from the scores, quantizes V
//   per column into V8^T (int8 wgmma has no transpose bit: its B operand
//   is K-major along the keys) and adds o += P8 . V8 on s8 wgmma. Where D
//   <= 64 and a row has at most two key tiles (L <= 256), the scores stay
//   in registers from pass A to pass B (0.33 against 0.44 ms scoring the
//   K tiles again); longer rows score them again;
// - P8 comes from the S accumulators with no shuffle and no trip through
//   shared memory: the s32 accumulator layout is not the s8 k32 A
//   fragment's, so V8^T's keys are permuted instead (quad_key) until each
//   thread's own scores are its A fragments (a byte permute and quad
//   shuffle of P8 against V8^T in key order took 0.229-0.230 ms against
//   0.219-0.221);
// - the conversions run on the FMA and integer pipes, not the
//   quarter-rate I2F / F2I (i2f_small, rint_bits), key tiles wholly
//   inside len skip the masks (0.22 against 0.33 ms), and exp2 is one
//   MUFU.EX2 (ex2: 0.211 against 0.219-0.221 ms with exp2f);
// - the epilogues (the rows, and the emission's read-back) are the bf16
//   kernel's (store_head, emit_rows).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "int8_rows.cuh"
#include "sm90.cuh"

namespace {

enum Mode { PREFIX = 0, SEGMENT = 1, WINDOW = 2, BIAS = 3, STREAM = 4,
            ALIBI = 5, BAND = 6, CAUSAL = 7, CAUSAL_ALIBI = 8 };

// the segment-masked modes: K4 (every key of the row) and K5 (a range of
// key tiles a query tile)
__host__ __device__ constexpr bool seg_mode(int mode) {
  return mode == SEGMENT || mode == WINDOW;
}

__host__ __device__ constexpr bool causal_mode(int mode) {
  return mode == CAUSAL || mode == CAUSAL_ALIBI;
}
__host__ __device__ constexpr bool alibi_mode(int mode) {
  return mode == ALIBI || mode == CAUSAL_ALIBI;
}

constexpr int KT = 128;       // keys per tile
constexpr int WG_ROWS = 64;   // query rows per consumer warpgroup
constexpr int BOX_ROWS = 64;  // rows per TMA box
constexpr int PRODUCER_REGS = 24;  // setmaxnreg: 24 + 2 x 240 = 3 x 168
constexpr int CONSUMER_REGS = 240;
constexpr int BAR_SCHED = 1;  // named barriers 1, 2: the warpgroups' turns
constexpr int BAR_WG = 3;     // 3, 4: one warpgroup's threads
constexpr float LOG2E_F = 1.4426950408889634f;
// K4 (mode 1 without emission): every head of a (query tile, sequence) in
// one block (true), or a block per (query tile, head, sequence) (false;
// both timed with tools/attention_ab.py)
constexpr bool SEG_ALL_HEADS = true;
// K5 (mode 2) the same way: every head in one block (true) or a block per
// head (false)
constexpr bool WIN_ALL_HEADS = true;
// K6w (mode 6) the same way: every head in one block (true) or a block per
// head (false; with BAND_PER_WG, 0.100-0.103 ms against 0.133-0.147 at
// ModernBERT's B=32, L=1,024 and B=4, L=8,192, window 128)
constexpr bool BAND_ALL_HEADS = true;
// K6w's key tiles: each consumer warpgroup walks only the tiles its own 64
// rows' band meets, and waits for and hands back the block's others
// without a product (true: at window 128 two of the block's three), or
// both walk the whole block's range (false; every head in one block,
// 0.100-0.103 ms against 0.132-0.136 at those shapes; both choices timed
// with tools/attention_ab.py, H100 at 700 W)
constexpr bool BAND_PER_WG = true;
// mode 3's block order: a bias of more bytes than this (half of the
// H100's 50 MB L2) runs the sequence index fastest, so the blocks that
// share a (query block, head) tile of it run together; a smaller one the
// query block fastest, as the other modes
constexpr size_t BIAS_L2_BYTES = 25u << 20;
constexpr int BIAS_COLS = 32;  // keys per bias box (128 bytes of f32)

// Per head dim and mode: a tile row is NH blocks of CW columns (RB
// bytes, the swizzle width: 128 bytes at D >= 64, 64 at D=32), each block
// a TMA box column; wgmma's layout type for that swizzle; the K/V ring's
// depth and mode 3's bias ring's (shared memory: the bias tile is 64 KB).
// DV: the V heads' width (MLA's 128 beside q and k heads of D = 192; D
// everywhere else), a V tile NHV blocks of CW columns.
template <int D, int MODE, int DV = D>
struct Cfg {
  static constexpr int CW = D < 64 ? D : 64;
  static constexpr int RB = CW * 2;
  static constexpr int NH = D / CW;
  static constexpr int NHV = DV / CW;
  static constexpr uint32_t LAYOUT = RB == 128 ? 1 : 2;
  static constexpr int STAGES = D >= 128 || (MODE == BIAS && D == 64) ? 2 : 3;
  static constexpr int BSTAGES = MODE != BIAS ? 0 : D == 128 ? 1 : 2;
  static constexpr uint32_t TILE_BYTES = KT * D * 2;  // one K tile
  static constexpr uint32_t VTILE_BYTES = KT * DV * 2;  // one V tile
  // modes 1, 2: a K stage's key segment ids come with it
  static constexpr uint32_t SEG_BYTES = seg_mode(MODE) ? KT * 4 : 0;
};

// The row sums of P on the tensor cores (P . a ones tile, an m64n8k16
// beside each k16 step of O += P . V) where ALiBi's longer score pass
// bounds the kernel at D <= 64 (2.01 against 2.42 ms at jina's B=4,
// L=8,192 on an H100 at 700 W, tools/attention_ab.py); elsewhere in the
// score pass, whose adds cost less there than the extra products (1.76
// against 1.97 ms in the plain mode at that shape).
__host__ __device__ constexpr bool ones_sum(int D, int mode) {
  return D <= 64 && alibi_mode(mode);
}

// Does a block run every head of its (query tile, sequence)? With
// emission (each row's absmax spans the heads), in K4 and in K5.
__host__ __device__ constexpr bool all_heads(int mode, int emit) {
  return emit != EMIT_NO || (mode == SEGMENT && SEG_ALL_HEADS) ||
         (mode == WINDOW && WIN_ALL_HEADS) ||
         (mode == BAND && BAND_ALL_HEADS);
}

// Mode 6: the 128-key tiles that hold a key of the band of query rows q0
// .. q0 + rows - 1 (keys q0 - W .. q0 + rows - 1 + W) below len: the first
// tile and the count (0: no key; the first then means nothing).
// ops/attention.py:band_tiles is the same arithmetic.
__device__ __forceinline__ int2 band_tiles(int q0, int rows, int W,
                                           int len) {
  const int lo = max(0, q0 - W);
  const int hi = min(len, q0 + rows + W);
  return lo < hi ? make_int2(lo / KT, (hi - 1) / KT - lo / KT + 1)
                 : make_int2(lo / KT, 0);
}

// Shared memory from a 1024-byte aligned base: the Q tile (NC x 64 rows;
// two of them, for heads h and h + 1, with emission), the K ring, the V
// ring, 1 KB of bf16 ones (the row sums' B operand), mode 3's bias ring,
// mode 1's key segment ids (one 128-key row a K stage), the emission's
// row absmax (QB f32), then the mbarriers: q full[QBUF], q empty[QBUF], K
// full[STAGES], V full, K empty, V empty, bias full[BSTAGES], bias
// empty. A tile of R rows holds column block c at c * R * RB and row r
// of it at r * RB (swizzled within 8-row groups); a bias tile holds
// warpgroup w's 64 rows at w * 32 KB, key block c (32 keys) of them at c
// * 8 KB, row r at r * 128 (its 16-byte chunks swizzled within 8-row
// groups).
template <int D, int NC, int MODE, int EMIT, int DV = D>
struct Smem {
  using C = Cfg<D, MODE, DV>;
  static constexpr int QB = NC * WG_ROWS;
  static constexpr int QBUF = all_heads(MODE, EMIT) ? 2 : 1;
  static constexpr uint32_t q_bytes = QB * D * 2;  // one Q tile
  static constexpr uint32_t k_off = QBUF * q_bytes;
  static constexpr uint32_t v_off = k_off + C::STAGES * C::TILE_BYTES;
  static constexpr uint32_t ones_off = v_off + C::STAGES * C::VTILE_BYTES;
  static constexpr uint32_t b_off = ones_off + 1024;
  static constexpr uint32_t b_tile_bytes = QB * KT * 4;
  static constexpr uint32_t seg_off = b_off + C::BSTAGES * b_tile_bytes;
  static constexpr uint32_t rmax_off = seg_off + C::STAGES * C::SEG_BYTES;
  static constexpr uint32_t bar_off =
      rmax_off + (EMIT != EMIT_NO ? QB * 4 : 0);
  static constexpr size_t bytes =
      1024 + bar_off + (2 * QBUF + 4 * C::STAGES + 2 * C::BSTAGES) * 8;
};
static_assert(Smem<128, 2, STREAM, EMIT_NO>::bytes <= 232448, "D=128 block");
static_assert(Smem<64, 2, STREAM, EMIT_NO>::bytes <= 232448, "D=64 block");
static_assert(Smem<128, 2, BIAS, EMIT_NO>::bytes <= 232448,
              "D=128 bias block");
static_assert(Smem<64, 2, BIAS, EMIT_NO>::bytes <= 232448, "D=64 bias block");
static_assert(Smem<128, 2, SEGMENT, EMIT_ONLY>::bytes <= 232448,
              "D=128 emitting block");
static_assert(Smem<128, 2, SEGMENT, EMIT_NO>::bytes <= 232448,
              "D=128 segment block");
static_assert(Smem<128, 2, BAND, EMIT_NO>::bytes <= 232448, "D=128 band block");
static_assert(Smem<192, 2, CAUSAL, EMIT_NO, 128>::bytes <= 232448,
              "MLA block");

struct Args {
  const int* lengths;   // [B] int32 (modes 0, 3-8)
  const int* seg;       // [B, L] int32 (modes 1, 2)
  const int* kbs;       // [B, L/128] int32 (mode 2): first key tile
  const int* kbe;       // [B, L/128] int32 (mode 2): last key tile
  int W;                // mode 2: the key-tile cap; mode 6: window // 2
  const float* slopes;  // [H] f32 (modes 5, 8)
  __nv_bfloat16* out;   // [B*Lq, E] (not with "only" emission)
  int8_t* o8;           // emission: [B*L, E] codes
  float* os;            // emission: [B*L] row scales
  float* scratch;       // "only" emission: [B*L, E] f32 context
  int L, H;             // keys a sequence, heads
  int Lq;               // query rows a sequence (L, or the CP layout's Lc)
  float s2, hi;
  int batch_fastest;    // mode 3: grid (B, q-blocks, H)
};

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&t);
}

// the two bf16 halves of a packed pair, as f32
__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// two f32 from shared memory (8-byte aligned)
__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// two int32 from shared memory (8-byte aligned)
__device__ __forceinline__ int2 ld_shared_i2(uint32_t addr) {
  int2 v;
  asm volatile("ld.shared.v2.s32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y) : "r"(addr) : "memory");
  return v;
}

// One tile's score pass for this thread's two query rows (r0 and r0 + 8)
// and 64 keys, in place: s[4j + e] is row e < 2 ? r0 : r0 + 8, key k0 + 2
// * quad + 8j + (e & 1). fq[r]: f32(row - k0 - 2 * quad) (ALiBi's
// distance, exact in f32); lim[r]: the row's valid keys end, minus k0 + 2
// * quad; mode 6: lo[r], the row's first valid key, minus k0 + 2 * quad
// (the band's lower end; its upper end is in lim). Mode 3: bq, the
// shared address of row r0's bias pair in key block 0 of the tile's bias
// stage (row r0 + 8's is 1 KB on), boff[m] the swizzled chunk offset of
// keys 8m.. within a 32-key block. Mode 1: sk, the shared address of key
// k0 + 2 * quad's segment id in the tile's K stage, sq[r] the row's
// segment id (-2 for a pad row: no key matches).
// Leaves the probabilities in s: with ONES_SUM as they are (the
// A-fragment conversion rounds them and the tensor cores sum them), else
// rounded to bf16, and adds them to the row sums.
template <int MODE, bool MASKED, bool ONES_SUM>
__device__ __forceinline__ void score_pass(float* s, float* sum, float s2,
                                           float hi, float slope,
                                           const float* fq, const int* lim,
                                           const int* lo, uint32_t bq,
                                           const uint32_t* boff, uint32_t sk,
                                           const int* sq) {
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    float v[4];
    float bias[4];
    int2 kseg = make_int2(0, 0);
    if constexpr (MODE == BIAS) {
      const uint32_t at = bq + (j / 4) * (BIAS_COLS * 64 * 4) + boff[j % 4];
      const float2 b0 = ld_shared_f2(at), b1 = ld_shared_f2(at + 8 * 128);
      bias[0] = b0.x;
      bias[1] = b0.y;
      bias[2] = b1.x;
      bias[3] = b1.y;
    }
    if constexpr (seg_mode(MODE)) kseg = ld_shared_i2(sk + 32 * j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + (e & 1);
      float raw = s[4 * j + e];
      if constexpr (MODE == BIAS) {
        raw = __fadd_rn(__fmul_rn(raw, s2), bias[e]);
      } else if constexpr (alibi_mode(MODE)) {
        const float dist =
            __fmul_rn(fabsf(__fsub_rn(fq[e >> 1], (float)c)), LOG2E_F);
        raw = __fsub_rn(__fmul_rn(raw, s2), __fmul_rn(slope, dist));
      } else if constexpr (MODE != PREFIX) {
        raw = __fmul_rn(raw, s2);
      }
      float p = ex2(fminf(fmaxf(raw, -100.0f), hi));
      if constexpr (MASKED) p = c < lim[e >> 1] ? p : 0.0f;
      if constexpr (MODE == BAND) p = c >= lo[e >> 1] ? p : 0.0f;
      if constexpr (seg_mode(MODE))
        p = ((e & 1) ? kseg.y : kseg.x) == sq[e >> 1] ? p : 0.0f;
      v[e] = p;
    }
    if constexpr (ONES_SUM) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * j + e] = v[e];
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t w = pack2(v[2 * r], v[2 * r + 1]);
        s[4 * j + 2 * r] = lo_bf16(w);
        s[4 * j + 2 * r + 1] = hi_bf16(w);
        sum[r] += s[4 * j + 2 * r];
        sum[r] += s[4 * j + 2 * r + 1];
      }
    }
  }
}

// the bf16 probabilities in s as wgmma's A fragments: the m64nN f32
// accumulator layout is the k16 A-fragment layout, so p[2j] is row r0's
// keys 8j.., p[2j + 1] row r0 + 8's, and k16 step kk reads p[4kk ..]
__device__ __forceinline__ void to_fragments(const float* s, uint32_t* p) {
#pragma unroll
  for (int i = 0; i < KT / 4; ++i) p[i] = pack2(s[2 * i], s[2 * i + 1]);
}

// O += P . V for one 128-key tile: 8 k16 steps, A from registers; dv: the
// V tile's descriptor. With ONES_SUM also rs += P . ones (d1: the ones
// tile's descriptor), every column of rs a row sum.
template <int D, bool ONES_SUM>
__device__ __forceinline__ void pv_product(float* o, float* rs,
                                           const uint32_t* p, uint64_t dv,
                                           uint64_t d1) {
  using C = Cfg<D, PREFIX>;  // (the row width does not depend on the mode)
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    const uint64_t db = dv + ((kk * 16 * C::RB) >> 4);
    if constexpr (D == 128)
      wgmma_rs_m64n128k16(o, p + 4 * kk, db, 1);
    else if constexpr (D == 64)
      wgmma_rs_m64n64k16(o, p + 4 * kk, db, 1);
    else
      wgmma_rs_m64n32k16(o, p + 4 * kk, db, 1);
    if constexpr (ONES_SUM) wgmma_rs_m64n8k16(rs, p + 4 * kk, d1, 1);
  }
}

// 16 bytes of global memory in each of n consecutive vectors
template <int N>
__device__ __forceinline__ void ld_vecs(const void* src, uint4* v) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = reinterpret_cast<const uint4*>(src)[i];
}

// One head's context for this thread's two query rows (row0 and row0 +
// 8; columns h*D + 8j + 2*quad + e), the f32 value of accumulator i = 4j
// + 2r + e being ctx(r, i): written as bf16 to out, or with "only" as
// f32 to the scratch; with emission the rows' running absmax goes on in
// amax (of the bf16 values with "both"). Rows >= Lq are not written.
template <int D, int EMIT, typename Ctx>
__device__ __forceinline__ void store_head(const Args& a, int b, int Lq,
                                           int row0, int h, int quad,
                                           float* amax, Ctx ctx) {
  const int E = a.H * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Lq) continue;
    const size_t at = ((size_t)b * Lq + row) * E + h * D + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x = ctx(r, 4 * j + 2 * r);
      const float y = ctx(r, 4 * j + 2 * r + 1);
      if constexpr (EMIT == EMIT_ONLY) {
        *reinterpret_cast<float2*>(a.scratch + at + 8 * j) =
            make_float2(x, y);
        amax[r] = fmaxf(amax[r], fmaxf(fabsf(x), fabsf(y)));
      } else {
        const uint32_t w = pack2(x, y);
        *reinterpret_cast<uint32_t*>(a.out + at + 8 * j) = w;
        if constexpr (EMIT == EMIT_BOTH)
          amax[r] = fmaxf(amax[r],
                          fmaxf(fabsf(lo_bf16(w)), fabsf(hi_bf16(w))));
      }
    }
  }
}

// The emission of a consumer warpgroup's 64 rows (query rows qw0 ..) once
// every head is written: each row's absmax (amax: this thread's two rows,
// rw and rw + 8, reduced over the quad) through rmax (the warpgroup's 64
// f32 in shared memory), then the rows re-read (16-byte loads, a 128-byte
// line or 16 bf16 a thread), their codes written with 16-byte stores and
// their scales; "only" drops each scratch line from L2 unwritten.
template <int EMIT>
__device__ __forceinline__ void emit_rows(const Args& a, float* rmax,
                                          float* amax, int tid, int quad,
                                          int rw, int L, int qw0, int b,
                                          int E) {
  const int wg = tid / 128;
  amax[0] = quad_max(amax[0]);
  amax[1] = quad_max(amax[1]);
  if (quad == 0) {
    rmax[rw] = amax[0];
    rmax[rw + 8] = amax[1];
  }
  __threadfence_block();
  named_bar(BAR_WG + wg, 128);
  const int wt = tid % 128;
  const int rows = min(WG_ROWS, L - qw0);
  const size_t row_base = (size_t)b * L + qw0;
  if (wt < rows) a.os[row_base + wt] = fmaxf(rmax[wt], 1e-30f) * INV127;
  // a unit: 32 f32 (a 128-byte line) or 16 bf16 a thread, 32 or 16 codes
  constexpr int U = EMIT == EMIT_ONLY ? 32 : 16;
  const int per_row = E / U;
  for (int u = wt; u < rows * per_row; u += 128) {
    const int r = u / per_row;
    const size_t at = (row_base + r) * E + (u - r * per_row) * U;
    const float rcp = 1.0f / (fmaxf(rmax[r], 1e-30f) * INV127);
    float v[U];
    if constexpr (EMIT == EMIT_ONLY) {
      uint4 w[8];
      ld_vecs<8>(a.scratch + at, w);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[4 * i] = __uint_as_float(w[i].x);
        v[4 * i + 1] = __uint_as_float(w[i].y);
        v[4 * i + 2] = __uint_as_float(w[i].z);
        v[4 * i + 3] = __uint_as_float(w[i].w);
      }
    } else {
      uint4 w[2];
      ld_vecs<2>(a.out + at, w);
      const uint32_t* x = reinterpret_cast<const uint32_t*>(w);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[2 * i] = lo_bf16(x[i]);
        v[2 * i + 1] = hi_bf16(x[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < U / 16; ++i) {
      const uint2 c0 = codes8(v + 16 * i, rcp);
      const uint2 c1 = codes8(v + 16 * i + 8, rcp);
      *reinterpret_cast<uint4*>(a.o8 + at + 16 * i) =
          make_uint4(c0.x, c0.y, c1.x, c1.y);
    }
    // the scratch line is never read again: dropped from L2 unwritten,
    // it costs no write to HBM (K2e "only" at bge's shape 0.014-0.017
    // ms faster than without it, K4e at 256 x 128 0.006-0.008;
    // tools/attention_ab.py, H100 at 700 W)
    if constexpr (EMIT == EMIT_ONLY)
      asm volatile("discard.global.L2 [%0], 128;\n" ::"l"(a.scratch + at)
                   : "memory");
  }
}

// qmap: the Q rows (qkv [B, L, 3E], or the CP layout's q [B, Lc, E]);
// kvmap: the K and V rows (qkv again, or the CP layout's kv [B, L, 2E]);
// bmap: mode 3's bias [H, L, L]; smap: mode 1's seg [B, L] (each unused
// by the other modes). EMIT: emission (modes 0 and 1); with it, and in
// K4, the block runs every head of its (query tile, sequence), see the
// design notes. CP: 1 the CP layout (mode 4), 0 the fused one. DV: the V
// heads' width, D but in MLA (mode 7 alone: qkv [B, L, H*(2D + DV)], q at
// h*D, k at H*D + h*D, v at 2H*D + h*DV, out [B*L, H*DV]). The kernels
// below are this body under their own names.
template <int D, int MODE, int NC, int EMIT, int CP, int DV>
__device__ __forceinline__ void attn_sm90_body(const CUtensorMap& qmap,
                                               const CUtensorMap& kvmap,
                                               const CUtensorMap& bmap,
                                               const CUtensorMap& smap,
                                               const Args& a) {
  using C = Cfg<D, MODE, DV>;
  using S = Smem<D, NC, MODE, EMIT, DV>;
  constexpr int QB = S::QB;
  constexpr int STAGES = C::STAGES;
  constexpr int BS = C::BSTAGES > 0 ? C::BSTAGES : 1;  // mode 3's bias ring
  constexpr int RB = C::RB;
  constexpr bool ONES = ones_sum(D, MODE);
  constexpr bool EMITS = EMIT != EMIT_NO;
  constexpr bool ALL_HEADS = all_heads(MODE, EMIT);
  constexpr int QBUF = S::QBUF;
  static_assert(!EMITS || MODE == PREFIX || MODE == SEGMENT,
                "emission is modes 0 and 1");
  static_assert(CP == 0 || (MODE == STREAM && !EMITS),
                "the CP layout is mode 4's, without emission");
  static_assert((MODE != WINDOW && MODE != BAND) || NC == 2,
                "modes 2 and 6 take 128-row query blocks");
  static_assert(DV == D || (MODE == CAUSAL && !EMITS && CP == 0 && NC == 2),
                "another V width is MLA's, in mode 7");
  const bool batch_fastest = MODE == BIAS && a.batch_fastest;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw_base);
  const uint32_t qs = base;
  const uint32_t bars = base + S::bar_off;
  auto q_full = [&](int i) { return bars + 8 * i; };
  auto q_empty = [&](int i) { return bars + 8 * (QBUF + i); };
  const uint32_t ring = bars + 8 * 2 * QBUF;
  auto k_full = [&](int s) { return ring + 8 * s; };
  auto v_full = [&](int s) { return ring + 8 * (STAGES + s); };
  auto k_empty = [&](int s) { return ring + 8 * (2 * STAGES + s); };
  auto v_empty = [&](int s) { return ring + 8 * (3 * STAGES + s); };
  auto b_full = [&](int s) { return ring + 8 * (4 * STAGES + s); };
  auto b_empty = [&](int s) { return ring + 8 * (4 * STAGES + BS + s); };

  const int tid = threadIdx.x;
  // the warpgroup, and below the row length, broadcast from lane 0: values
  // the compiler can see are warp-uniform, so the branches on them are no
  // divergent paths, which would make it serialize the wgmma instructions
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int L = a.L;
  const int Lq = a.Lq;
  const int E = a.H * D;
  int qb, h_block, b;
  if constexpr (ALL_HEADS) {
    // block i: the (i % q-tiles)-th query tile of the (i / q-tiles)-th
    // sequence from the last
    const int nqb = (Lq + QB - 1) / QB;
    qb = blockIdx.x % nqb;
    b = gridDim.x / nqb - 1 - blockIdx.x / nqb;
    h_block = 0;
  } else {
    // causal blocks run longest first: the last query block first; mode 3
    // with a large bias runs the sequences of one (query block, head)
    // together
    qb = batch_fastest ? blockIdx.y
         : causal_mode(MODE) ? gridDim.x - 1 - blockIdx.x
                             : blockIdx.x;
    h_block = batch_fastest ? blockIdx.z : blockIdx.y;
    b = batch_fastest ? blockIdx.x : blockIdx.z;
  }
  const int q0 = qb * QB;
  // the heads this block runs: every one with emission and in K4, else
  // its own
  const int n_heads = ALL_HEADS ? a.H : 1;
  // modes 1, 2 mask keys by segment, not by a prefix: every key below L
  const int len = __shfl_sync(
      0xffffffffu,
      seg_mode(MODE) ? L : min(max(a.lengths[b], 0), L), 0);
  // key tiles past len add exact zeros, and so do those past a causal
  // block's last query row
  int k_end = (len + KT - 1) / KT * KT;
  if (causal_mode(MODE)) k_end = min(k_end, q0 + QB);
  int nt = (k_end + KT - 1) / KT;
  // the block's key tiles: t0 .. t0 + nt - 1; mode 2 walks key tiles kbs ..
  // min(kbs + W - 1, kbe) of its 128-row query block (kbe < kbs, an
  // all-pad block: none), broadcast from lane 0 as len is
  int t0 = 0;
  if constexpr (MODE == WINDOW) {
    const int at = b * (L / KT) + qb;
    t0 = __shfl_sync(0xffffffffu, a.kbs[at], 0);
    const int last =
        __shfl_sync(0xffffffffu, min(t0 + a.W - 1, a.kbe[at]), 0);
    nt = max(last - t0 + 1, 0);
  }
  // mode 6 walks the key tiles the band of its 128 rows meets below len
  // (an empty range: none), broadcast from lane 0 as mode 2's
  if constexpr (MODE == BAND) {
    const int2 r = band_tiles(q0, QB, a.W, len);
    t0 = __shfl_sync(0xffffffffu, r.x, 0);
    nt = __shfl_sync(0xffffffffu, r.y, 0);
  }

  if constexpr (ONES) {
    for (int i = tid; i < 256; i += blockDim.x)
      reinterpret_cast<uint32_t*>(sbase + S::ones_off)[i] = 0x3F803F80u;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (tid == 0) {
    for (int i = 0; i < QBUF; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), 4 * NC);  // one lane per consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * NC);
      mbar_init(v_empty(s), 4 * NC);
    }
    for (int s = 0; s < C::BSTAGES; ++s) {
      mbar_init(b_full(s), 1);
      mbar_init(b_empty(s), 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role >= NC) {
    // ---- producer: each head's Q, then its K and V tiles through the
    // ring (ring tile g counts on across heads) ----
    if constexpr (NC == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          PRODUCER_REGS));
    if (tid != 128 * NC) return;
    // the K and V columns: qkv's k at E + h*D, v at 2E + h*DV; the CP
    // layout's kv [B, L, 2E] k at h*D, v at E + h*D
    const int kv_col = CP ? 0 : E;
    int g = 0;
    for (int hh = 0; hh < n_heads; ++hh) {
      const int h = ALL_HEADS ? hh : h_block;
      const int qi = hh % QBUF;
      // (a fresh barrier's phase "before 0" reads as complete)
      if constexpr (ALL_HEADS)
        mbar_wait(q_empty(qi), ((hh / QBUF) & 1) ^ 1);
      mbar_expect_tx(q_full(qi), S::q_bytes);
#pragma unroll
      for (int c = 0; c < C::NH; ++c)
#pragma unroll
        for (int rc = 0; rc < QB / BOX_ROWS; ++rc)
          tma_load_3d(qs + qi * S::q_bytes + (c * QB + rc * BOX_ROWS) * RB,
                      &qmap, h * D + c * C::CW, q0 + rc * BOX_ROWS, b,
                      q_full(qi));
      for (int t = 0; t < nt; ++t, ++g) {
        const int s = g % STAGES;
        const uint32_t ph = (g / STAGES) & 1;
        const int k0 = (t0 + t) * KT;
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {  // K, then V
          const uint32_t full = kv ? v_full(s) : k_full(s);
          mbar_wait(kv ? v_empty(s) : k_empty(s), ph ^ 1);
          mbar_expect_tx(full,
                         kv ? C::VTILE_BYTES : C::TILE_BYTES + C::SEG_BYTES);
          const uint32_t tile =
              base + (kv ? S::v_off + s * C::VTILE_BYTES
                         : S::k_off + s * C::TILE_BYTES);
          const int col = kv ? kv_col + E + h * DV : kv_col + h * D;
#pragma unroll
          for (int c = 0; c < (kv ? C::NHV : C::NH); ++c)
#pragma unroll
            for (int rc = 0; rc < KT / BOX_ROWS; ++rc)
              tma_load_3d(tile + (c * KT + rc * BOX_ROWS) * RB, &kvmap,
                          col + c * C::CW, k0 + rc * BOX_ROWS, b, full);
          if constexpr (seg_mode(MODE)) {
            // the keys' segment ids, with K (keys past L read as 0)
            if (kv == 0)
              tma_load_2d(base + S::seg_off + s * C::SEG_BYTES, &smap, k0,
                          b, full);
          }
          if constexpr (MODE == BIAS) {
            if (kv == 0) {
              // the tile's bias, needed with its K (V only a tile later):
              // each warpgroup's 64 rows x 128 keys, in boxes of 32 keys
              // (rows and keys past L read as zeros)
              const int bs = t % BS;
              mbar_wait(b_empty(bs), ((t / BS) & 1) ^ 1);
              mbar_expect_tx(b_full(bs), S::b_tile_bytes);
              const uint32_t bt = base + S::b_off + bs * S::b_tile_bytes;
#pragma unroll
              for (int w = 0; w < NC; ++w)
#pragma unroll
                for (int c = 0; c < KT / BIAS_COLS; ++c)
                  tma_load_3d(
                      bt + (w * (KT / BIAS_COLS) + c) * (BIAS_COLS * 64 * 4),
                      &bmap, k0 + c * BIAS_COLS, q0 + w * WG_ROWS, h,
                      b_full(bs));
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg holds query rows q0 + 64 wg .. + 63 ----
  if constexpr (NC == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        CONSUMER_REGS));
  const int wg = role;
  const int lane = tid % 32;
  const int quad = lane & 3;
  const int qw0 = q0 + wg * WG_ROWS;
  const int rw = ((tid % 128) / 32) * 16 + (lane >> 2);  // row in the wg
  const int row0 = qw0 + rw;
  // this warpgroup's key tiles: lead .. lead + ntw - 1 of the block's t0 ..
  // t0 + nt - 1. All of them, but in mode 6 with BAND_PER_WG those its own
  // rows' band meets (a contiguous part: warpgroup 0's rows start the
  // block's band, warpgroup 1's end it); it waits for the others and hands
  // them back without a product (skip_turn)
  int lead = 0, ntw = nt;
  if constexpr (MODE == BAND && BAND_PER_WG) {
    const int2 r = band_tiles(qw0, WG_ROWS, a.W, len);
    ntw = __shfl_sync(0xffffffffu, r.y, 0);
    lead = __shfl_sync(0xffffffffu, r.y > 0 ? r.x - t0 : nt, 0);
  }
  // modes 1, 2: the two rows' segment ids (a pad row, or a row past L,
  // -2: it matches no key), and this thread's first key id in a K stage
  int sq[2] = {-2, -2};
  if constexpr (seg_mode(MODE)) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const int id = row < L ? a.seg[(size_t)b * L + row] : -1;
      sq[r] = id >= 0 ? id : -2;
    }
  }
  const uint32_t sk0 = base + S::seg_off + 8 * quad;
  // mode 3: this thread's bias pairs in a bias stage (see score_pass)
  const uint32_t bq = base + S::b_off + wg * (WG_ROWS * KT * 4) + rw * 128 +
                      8 * (quad & 1);
  uint32_t boff[4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
    boff[m] = ((2 * m + (quad >> 1)) ^ (rw & 7)) << 4;

  float o[DV / 2];
  float s[KT / 2];
  uint32_t p[KT / 4];
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) s[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < KT / 4; ++i) p[i] = 0u;
  float amax[2] = {0.0f, 0.0f};  // emission: the two rows' running absmax

  // the descriptors of this warpgroup's rows of Q buffer 0 and of ring
  // stage 0's K and V tiles; a buffer, a stage, a column block and a k16
  // step move the start address (the low 14 bits, in 16-byte units: no
  // carry, shared memory is < 256 KB)
  const uint64_t dq0 = smem_desc(qs + wg * WG_ROWS * RB, 16, 8 * RB,
                                 C::LAYOUT);
  const uint64_t dk = smem_desc(base + S::k_off, 16, 8 * RB, C::LAYOUT);
  const uint64_t dv = smem_desc(base + S::v_off, KT * RB, 8 * RB, C::LAYOUT);
  // the ones tile, K-major without swizzle: 8 x 16-byte rows a core
  // matrix, the two of a k16 step 128 bytes apart (all within the 1 KB)
  const uint64_t d1 = smem_desc(base + S::ones_off, 128, 256, 0);
  // the warpgroups take turns issuing their products (warpgroup 0 first):
  // each takes nt + 1 turns a head, and passes each but warpgroup 1's last
  // of the last head
  auto take_turn = [&]() {
    if constexpr (NC == 2) named_bar(BAR_SCHED + wg, 256);
  };
  auto pass_turn = [&]() {
    if constexpr (NC == 2) named_bar_arrive(BAR_SCHED + 1 - wg, 256);
  };
  if constexpr (NC == 2)
    if (nt > 0 && wg == 1) named_bar_arrive(BAR_SCHED, 256);

  int g0 = 0;  // ring tiles of the heads before this one
  for (int hh = 0; hh < n_heads; ++hh) {
    const int h = ALL_HEADS ? hh : h_block;
    const int qi = hh % QBUF;
    const uint64_t dq = dq0 + ((qi * S::q_bytes) >> 4);
    const float slope = alibi_mode(MODE) ? a.slopes[h] : 0.0f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
    float sum[2] = {0.0f, 0.0f};
    float rs[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // ONES: the row sums

    mbar_wait(q_full(qi), (hh / QBUF) & 1);
    if constexpr (MODE == PREFIX) {
      // q * s2 rounded to bf16, in place (elementwise: the swizzle does
      // not matter), then made visible to wgmma's async proxy
      constexpr int VECS = WG_ROWS * RB / 16;  // 16-byte vectors a block
#pragma unroll
      for (int c = 0; c < C::NH; ++c)
        for (int i = tid % 128; i < VECS; i += 128) {
          uint4* ptr = reinterpret_cast<uint4*>(
              sbase + qi * S::q_bytes + (c * QB + wg * WG_ROWS) * RB +
              i * 16);
          uint4 u = *ptr;
          uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            w[k] = pack2(lo_bf16(w[k]) * a.s2, hi_bf16(w[k]) * a.s2);
          *ptr = u;
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_bar(BAR_WG + wg, 128);
    }

    // S = Q . K^T for the K tile in ring stage st
    auto issue_scores = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 / C::CW;
        const uint32_t off = (kk * 16 % C::CW) * 2;
        wgmma_m64n128k16(s, dq + ((c * QB * RB + off) >> 4),
                         dk + ((st * C::TILE_BYTES + c * KT * RB + off) >> 4),
                         kk > 0);
      }
    };
    // tile t's K stage goes back once its scores are done (modes 1, 2:
    // once the score pass has read its segment ids)
    auto release_k = [&](int g) {
      if constexpr (seg_mode(MODE)) __syncwarp();
      if (lane == 0) mbar_arrive(k_empty(g % STAGES));
    };
    // tile t (ring tile g)'s score pass, once its S is complete: in place,
    // and the sums
    auto score_tile = [&](int t, int g) {
      const int k0 = (t0 + lead + t) * KT;
      const int kq = k0 + 2 * quad;
      const float fq[2] = {(float)(row0 - kq), (float)(row0 + 8 - kq)};
      int lim[2] = {len - kq, len - kq};
      int lo[2] = {0, 0};
      if constexpr (causal_mode(MODE)) {
        lim[0] = min(len, row0 + 1) - kq;
        lim[1] = min(len, row0 + 9) - kq;
      }
      if constexpr (MODE == BAND) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          lim[r] = min(len, row0 + 8 * r + a.W + 1) - kq;
          lo[r] = row0 + 8 * r - a.W - kq;
        }
      }
      const uint32_t bt = bq + (t % BS) * S::b_tile_bytes;
      const uint32_t sk = sk0 + (g % STAGES) * C::SEG_BYTES;
      // (with W = 64 no 128-key tile lies inside a row's band: mode 6
      // masks every tile)
      if (seg_mode(MODE) || MODE == BAND || k0 + KT > len ||
          (causal_mode(MODE) && k0 + KT - 1 > qw0))
        score_pass<MODE, true, ONES>(s, sum, a.s2, a.hi, slope, fq, lim, lo,
                                     bt, boff, sk, sq);
      else
        score_pass<MODE, false, ONES>(s, sum, a.s2, a.hi, slope, fq, lim,
                                      lo, bt, boff, sk, sq);
      if constexpr (MODE == BIAS) {
        // every lane's bias reads are done: the stage goes back
        __syncwarp();
        if (lane == 0) mbar_arrive(b_empty(t % BS));
      }
    };
    // mode 3: tile t's bias has landed
    auto wait_bias = [&](int t) {
      if constexpr (MODE == BIAS) mbar_wait(b_full(t % BS), (t / BS) & 1);
    };

    // mode 6 with BAND_PER_WG: a tile of the block's range that this
    // warpgroup's rows have no key in. It waits for the tile (so its
    // arrivals count toward that tile's phase of the empty barriers, not an
    // earlier one's), hands the stage back, and takes a turn without a
    // product: both warpgroups take nt + 1 turns a head, as the walk of nt
    // tiles does. last: this warpgroup's last turn of the head.
    auto skip_turn = [&](int g, bool last) {
      if (g >= 0) {
        const int st = g % STAGES;
        const uint32_t ph = (g / STAGES) & 1;
        mbar_wait(k_full(st), ph);
        mbar_wait(v_full(st), ph);
        if (lane == 0) {
          mbar_arrive(k_empty(st));
          mbar_arrive(v_empty(st));
        }
      }
      take_turn();
      if (!last || wg == 0 || hh + 1 < n_heads) pass_turn();
    };
    if constexpr (MODE == BAND && BAND_PER_WG) {
      for (int i = 0; i < lead; ++i) skip_turn(g0 + i, false);
      // no tile of its own: one more turn, in place of the walk's last
      if (nt > 0 && ntw == 0) skip_turn(-1, true);
    }
    const int gb = g0 + lead;  // the ring tile of this warpgroup's first
    if (ntw > 0) {
      // tile 0: its scores alone
      mbar_wait(k_full(gb % STAGES), (gb / STAGES) & 1);
      wait_bias(0);
      take_turn();
      fence_regs<KT / 2>(s);
      wgmma_fence();
      issue_scores(gb % STAGES);
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      fence_regs<KT / 2>(s);
      if constexpr (!seg_mode(MODE)) release_k(gb);
      score_tile(0, gb);
      if constexpr (seg_mode(MODE)) release_k(gb);
      to_fragments(s, p);
      // tiles 1 .. ntw - 1: the scores of tile t issued with the product
      // of tile t - 1, and tile t's score pass run while that product runs
      for (int t = 1; t < ntw; ++t) {
        const int g = gb + t;
        const int sc = g % STAGES;
        const int sp = (g - 1) % STAGES;
        mbar_wait(k_full(sc), (g / STAGES) & 1);
        mbar_wait(v_full(sp), ((g - 1) / STAGES) & 1);
        wait_bias(t);
        take_turn();
        fence_regs<KT / 2>(s);
        fence_regs<DV / 2>(o);
        fence_regs<4>(rs);
        fence_regs<KT / 4>(p);
        wgmma_fence();
        issue_scores(sc);
        wgmma_commit();
        pv_product<DV, ONES>(o, rs, p, dv + ((sp * C::VTILE_BYTES) >> 4), d1);
        wgmma_commit();
        pass_turn();
        wgmma_wait<1>();
        fence_regs<KT / 2>(s);
        if constexpr (!seg_mode(MODE)) release_k(g);
        score_tile(t, g);
        if constexpr (seg_mode(MODE)) release_k(g);
        wgmma_wait<0>();
        fence_regs<DV / 2>(o);
        fence_regs<4>(rs);
        fence_regs<KT / 4>(p);
        if (lane == 0) mbar_arrive(v_empty(sp));
        to_fragments(s, p);
      }
      // the last tile's product alone
      const int gl = gb + ntw - 1;
      const int sp = gl % STAGES;
      mbar_wait(v_full(sp), (gl / STAGES) & 1);
      take_turn();
      fence_regs<DV / 2>(o);
      fence_regs<4>(rs);
      fence_regs<KT / 4>(p);
      wgmma_fence();
      pv_product<DV, ONES>(o, rs, p, dv + ((sp * C::VTILE_BYTES) >> 4), d1);
      wgmma_commit();
      if (wg == 0 || hh + 1 < n_heads || lead + ntw < nt) pass_turn();
      wgmma_wait<0>();
      fence_regs<DV / 2>(o);
      fence_regs<4>(rs);
      if (lane == 0) mbar_arrive(v_empty(sp));
    }
    if constexpr (MODE == BAND && BAND_PER_WG)
      for (int i = lead + ntw; i < nt; ++i) skip_turn(g0 + i, i == nt - 1);
    // this head's Q buffer goes back (its every product is done)
    if constexpr (ALL_HEADS)
      if (lane == 0) mbar_arrive(q_empty(qi));
    g0 += nt;

    if constexpr (ONES) {
      sum[0] = rs[0];
      sum[1] = rs[2];
    } else {
      sum[0] = quad_sum(sum[0]);
      sum[1] = quad_sum(sum[1]);
    }
    const float inv[2] = {1.0f / fmaxf(sum[0], 1e-30f),
                          1.0f / fmaxf(sum[1], 1e-30f)};
    store_head<DV, EMIT>(a, b, Lq, row0, h, quad, amax,
                         [&](int r, int i) { return o[i] * inv[r]; });
  }

  if constexpr (EMITS)
    emit_rows<EMIT>(a, reinterpret_cast<float*>(sbase + S::rmax_off) +
                           wg * WG_ROWS,
                    amax, tid, quad, rw, L, qw0, b, E);
}

// The body's launches: attn_sm90_kernel<D, mode, NC, emit, cp> for every
// mode at one head width, and attn_sm90_kernel_mla<D, DV> for mode 7 at
// MLA's widths.
template <int D, int MODE, int NC, int EMIT, int CP>
__global__ void __launch_bounds__(128 * (NC + 1), 1) attn_sm90_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kvmap,
    const __grid_constant__ CUtensorMap bmap,
    const __grid_constant__ CUtensorMap smap, const Args a) {
  attn_sm90_body<D, MODE, NC, EMIT, CP, D>(qmap, kvmap, bmap, smap, a);
}

// MLA (K6c at DeepSeek-V2's widths): mode 7 with q and k heads D wide and
// v heads DV wide, all from one map of qkv [B, L, H*(2D + DV)]; the
// rotated key part, shared by every head, is in each head's K columns
// (the MLA half writes it H times). Two consumer warpgroups, as mode 7.
template <int D, int DV>
__global__ void __launch_bounds__(384, 1) attn_sm90_kernel_mla(
    const __grid_constant__ CUtensorMap map, const Args a) {
  attn_sm90_body<D, CAUSAL, 2, EMIT_NO, 0, DV>(map, map, map, map, a);
}

// ---- K2i8: int8 scores (the prefix mask), with or without emission ----

constexpr float LOG2_127 = 6.9886846867721655f;

// K2i8's tiles per head dim: the bf16 TMA tiles as the bf16 kernel's (row
// blocks of CW columns, RB bytes, swizzled to RB) and the ring's depth
// (one stage at D = 128, where the int8 tiles take a second stage's room).
template <int D>
struct I8Cfg {
  static constexpr int CW = D < 64 ? D : 64;
  static constexpr int RB = CW * 2;
  static constexpr int NH = D / CW;
  static constexpr int STAGES = D == 128 ? 1 : 3;
  static constexpr uint32_t TILE_BYTES = KT * D * 2;
};

// Shared memory from a 1024-byte aligned base: two bf16 Q tiles (head h +
// 1's lands while head h runs), the bf16 K ring, the V ring, then the
// int8 operands: the block's Q8 rows [QB][D], one K8 tile [128 keys][D]
// and one V8^T tile [D][128 key positions] that both consumer warpgroups
// fill and read, all in the unswizzled core-matrix layout (8 rows x 16
// bytes, 128 contiguous bytes, a core matrix; core matrices along K
// first, cm_off); the f32 below; the emission's row absmax (QB f32); the
// mbarriers: q full[2], q empty[2], K full[STAGES], V full, K empty, V
// empty.
template <int D, int NC, int EMIT>
struct I8Smem {
  using C = I8Cfg<D>;
  static constexpr int QB = NC * WG_ROWS;
  static constexpr uint32_t q_bytes = QB * D * 2;
  static constexpr uint32_t k_off = 2 * q_bytes;
  static constexpr uint32_t v_off = k_off + C::STAGES * C::TILE_BYTES;
  static constexpr uint32_t q8_off = v_off + C::STAGES * C::TILE_BYTES;
  static constexpr uint32_t k8_off = q8_off + QB * D;
  static constexpr uint32_t v8_off = k8_off + KT * D;
  static constexpr uint32_t f_off = v8_off + D * KT;
  // q scales [QB], key scales [2][KT], v's column scales and reciprocals
  // [D] each, the consumer warps' column maxima [4 NC][D]
  static constexpr int FLOATS = QB + 2 * KT + 2 * D + 4 * NC * D;
  static constexpr uint32_t rmax_off = f_off + FLOATS * 4;
  static constexpr uint32_t bar_off =
      rmax_off + (EMIT != EMIT_NO ? QB * 4 : 0);
  static constexpr size_t bytes = 1024 + bar_off + (4 + 4 * C::STAGES) * 8;
};
static_assert(I8Smem<128, 2, EMIT_ONLY>::bytes <= 232448, "D=128 K2i8 block");
static_assert(I8Smem<64, 2, EMIT_ONLY>::bytes <= 232448, "D=64 K2i8 block");

// byte offset of 16-byte chunk c16 of row r in a TMA tile of RB-byte rows
// (the 128-byte swizzle XORs the chunk with r % 8, the 64-byte one with
// (r / 2) % 4)
template <int RB>
__device__ __forceinline__ uint32_t sw_chunk(int r, int c16) {
  return r * RB + ((c16 ^ (RB == 128 ? (r & 7) : ((r >> 1) & 3))) << 4);
}

// byte offset of byte c (a multiple of 16 for a 16-byte store, or of 4)
// of row n in an int8 operand tile of kb bytes a row, the core-matrix
// layout: wgmma's K-major no-swizzle descriptor with the leading offset
// 128 (core matrices along K) and the stride offset 8 * kb (8-row groups)
__device__ __forceinline__ uint32_t cm_off(int n, int c, int kb) {
  return ((n >> 3) * (kb >> 4) + (c >> 4)) * 128 + (n & 7) * 16 + (c & 15);
}

// the absmax of the 8 bf16 values in w
__device__ __forceinline__ float absmax8(uint4 w) {
  const uint32_t x[4] = {w.x, w.y, w.z, w.w};
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    m = fmaxf(m, fmaxf(fabsf(lo_bf16(x[i])), fabsf(hi_bf16(x[i]))));
  return m;
}

// Conversions on the FMA and integer pipes, not the quarter-rate I2F and
// F2I, exact for |n|, |x| < 2^22: the float 1.5 * 2^23 = 12582912, whose
// low 22 mantissa bits are 0, as a bias. i2f_small: the f32 of the
// integer n (an s32 score: at most 127 * 127 * 128 in magnitude).
__device__ __forceinline__ float i2f_small(uint32_t n) {
  return __fsub_rn(__uint_as_float(n + 0x4B400000u), 12582912.0f);
}
// the bits of 12582912 + rint(x), rounded half to even as cvt.rni: their
// low byte is rint(x) mod 256 (an int8 code, or p8), and less 0x4B400000
// they are rint(x)
__device__ __forceinline__ uint32_t rint_bits(float x) {
  return __float_as_uint(__fadd_rn(x, 12582912.0f));
}
// the low bytes of a, b, c and d, packed little-endian
__device__ __forceinline__ uint32_t pack_bytes(uint32_t a, uint32_t b,
                                               uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// 16 bf16 values (two 16-byte chunks) -> their 16 int8 codes rint(v * rs)
__device__ __forceinline__ uint4 codes16(uint4 w0, uint4 w1, float rs) {
  const uint32_t x[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  uint32_t c[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c[2 * i] = rint_bits(__fmul_rn(lo_bf16(x[i]), rs));
    c[2 * i + 1] = rint_bits(__fmul_rn(hi_bf16(x[i]), rs));
  }
  return make_uint4(pack_bytes(c[0], c[1], c[2], c[3]),
                    pack_bytes(c[4], c[5], c[6], c[7]),
                    pack_bytes(c[8], c[9], c[10], c[11]),
                    pack_bytes(c[12], c[13], c[14], c[15]));
}

// Row r of a bf16 TMA tile (R rows a column block) quantized over `cols`
// of its D columns from column c0 (a multiple of 16), the row's absmax
// taken over `pair` threads (1, or 2 adjacent lanes holding its halves):
// codes to row n of the int8 operand tile at dst, the row's scale
// returned. The reciprocal is taken once, then multiplies (quantize_sym's
// order).
template <int D, int R>
__device__ __forceinline__ float quant_row(const unsigned char* tile, int r,
                                           int c0, int cols, int pair,
                                           unsigned char* dst, int n) {
  using C = I8Cfg<D>;
  float mx = 0.0f;
  for (int c = c0; c < c0 + cols; c += 8)
    mx = fmaxf(mx, absmax8(*reinterpret_cast<const uint4*>(
                       tile + (c / C::CW) * R * C::RB +
                       sw_chunk<C::RB>(r, (c % C::CW) / 8))));
  if (pair == 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float sc = fmaxf(mx, 1e-30f) * INV127;
  const float rs = 1.0f / sc;
  for (int c = c0; c < c0 + cols; c += 16) {
    const unsigned char* at = tile + (c / C::CW) * R * C::RB;
    const int u = (c % C::CW) / 8;
    *reinterpret_cast<uint4*>(dst + cm_off(n, c, D)) = codes16(
        *reinterpret_cast<const uint4*>(at + sw_chunk<C::RB>(r, u)),
        *reinterpret_cast<const uint4*>(at + sw_chunk<C::RB>(r, u + 1)), rs);
  }
  return sc;
}

// The consumer threads' units of a 128-key V tile: unit u (the thread's
// index, then on by the number of consumer threads, below 4D) is a key
// quad kq = u / (D/8) and 8 columns 8 * (u % (D/8)) .., the quad's keys
// quad_key(kq) + {0, 1, 8, 9}: 32(kq/8) + 16((kq/4)%2) + 2(kq%4) + {0, 1,
// 8, 9}. Those four keys are the four bytes of one A-fragment register of
// P8 (see the kernel), so in V8^T they sit at positions 4kq .. 4kq + 3.
__device__ __forceinline__ int quad_key(int kq) {
  return 32 * (kq >> 3) + 16 * ((kq >> 2) & 1) + 2 * (kq & 3);
}

// v's column absmax over a V tile (keys past L read as zeros): vmax[i] is
// this thread's running max of column 8 * (t % (D/8)) + i
template <int D, int NT>
__device__ __forceinline__ void vmax_tile(const unsigned char* tile, int t,
                                          float* vmax) {
  using C = I8Cfg<D>;
  constexpr int G = D / 8;
  for (int u = t; u < 4 * D; u += NT) {
    const int c = 8 * (u % G);
    const unsigned char* at = tile + (c / C::CW) * KT * C::RB;
    const int k = quad_key(u / G);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int key = k + (kk & 1) + 8 * (kk >> 1);
      const uint4 w = *reinterpret_cast<const uint4*>(
          at + sw_chunk<C::RB>(key, (c % C::CW) / 8));
      const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        vmax[2 * i] = fmaxf(vmax[2 * i], fabsf(lo_bf16(x[i])));
        vmax[2 * i + 1] = fmaxf(vmax[2 * i + 1], fabsf(hi_bf16(x[i])));
      }
    }
  }
}

// a V tile quantized per column (rsv: the reciprocals of v's column
// scales) into V8^T [D][128 positions], each key quad's four codes of a
// column one 4-byte store at its positions
template <int D, int NT>
__device__ __forceinline__ void quant_v(const unsigned char* tile, int t,
                                        const float* rsv,
                                        unsigned char* v8) {
  using C = I8Cfg<D>;
  constexpr int G = D / 8;
  for (int u = t; u < 4 * D; u += NT) {
    const int c = 8 * (u % G);
    const unsigned char* at = tile + (c / C::CW) * KT * C::RB;
    const int k = quad_key(u / G), pos = 4 * (u / G);
    uint32_t x[4][4];  // key kk's 8 values as bf16 pairs
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int key = k + (kk & 1) + 8 * (kk >> 1);
      const uint4 w = *reinterpret_cast<const uint4*>(
          at + sw_chunk<C::RB>(key, (c % C::CW) / 8));
      x[kk][0] = w.x;
      x[kk][1] = w.y;
      x[kk][2] = w.z;
      x[kk][3] = w.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float rs = rsv[c + i];
      uint32_t b[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        b[kk] = rint_bits(__fmul_rn(
            (i & 1) ? hi_bf16(x[kk][i >> 1]) : lo_bf16(x[kk][i >> 1]), rs));
      *reinterpret_cast<uint32_t*>(v8 + cm_off(c + i, pos, KT)) =
          pack_bytes(b[0], b[1], b[2], b[3]);
    }
  }
}

// K2i8: a block owns a (query tile, sequence) and runs every head in
// turn, the last sequence first. Per head: each warpgroup quantizes its Q
// rows; pass A streams the K tiles (to len; to L in a len-0 row), each
// quantized and scored for the row max m, and every V tile of the row for
// v's column scales; pass B streams the V tiles (and, unless the scores
// are held, the K tiles) again and adds p8 . v8 and the row sums. See the
// K2i8 notes at the top of the file.
template <int D, int NC, int EMIT>
__global__ void __launch_bounds__(128 * (NC + 1), 1) attn90_i8_kernel(
    const __grid_constant__ CUtensorMap map, const Args a) {
  using C = I8Cfg<D>;
  using S = I8Smem<D, NC, EMIT>;
  constexpr int QB = S::QB;
  constexpr int STAGES = C::STAGES;
  constexpr int RB = C::RB;
  constexpr int G = D / 8;
  constexpr int NT = 128 * NC;  // consumer threads
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw_base);
  const uint32_t bars = base + S::bar_off;
  auto q_full = [&](int i) { return bars + 8 * i; };
  auto q_empty = [&](int i) { return bars + 8 * (2 + i); };
  const uint32_t ring = bars + 32;
  auto k_full = [&](int s) { return ring + 8 * s; };
  auto v_full = [&](int s) { return ring + 8 * (STAGES + s); };
  auto k_empty = [&](int s) { return ring + 8 * (2 * STAGES + s); };
  auto v_empty = [&](int s) { return ring + 8 * (3 * STAGES + s); };

  const int tid = threadIdx.x;
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int L = a.L;
  const int H = a.H;
  const int E = H * D;
  const int nqb = (L + QB - 1) / QB;
  const int qb = blockIdx.x % nqb;
  const int b = gridDim.x / nqb - 1 - blockIdx.x / nqb;
  const int q0 = qb * QB;
  const int len =
      __shfl_sync(0xffffffffu, min(max(a.lengths[b], 0), L), 0);
  // the row's key tiles (v's column scales span them all), and those the
  // scores need: to len, or all of them in a len-0 row, whose keys all sit
  // at -1e30 (p8 = 127 each: the mean of v), as on the TPU
  const int nta = (L + KT - 1) / KT;
  const int ntk = len > 0 ? (len + KT - 1) / KT : nta;
  // where D <= 64, the scores of a row of up to two key tiles stay in
  // registers from pass A to pass B, which then reads no K tile again
  const bool hold = D <= 64 && ntk <= 2;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), 4 * NC);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * NC);
      mbar_init(v_empty(s), 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role >= NC) {
    // ---- producer: each head's Q, its K and V tiles for pass A (V to L,
    // K to the scores' end), then again for pass B ----
    if constexpr (NC == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          PRODUCER_REGS));
    if (tid != 128 * NC) return;
    int gk = 0, gv = 0;
    auto load = [&](int kv, int h, int t, int& g) {
      const int s = g % STAGES;
      const uint32_t full = kv ? v_full(s) : k_full(s);
      mbar_wait(kv ? v_empty(s) : k_empty(s), ((g / STAGES) & 1) ^ 1);
      mbar_expect_tx(full, C::TILE_BYTES);
      const uint32_t tile =
          base + (kv ? S::v_off : S::k_off) + s * C::TILE_BYTES;
#pragma unroll
      for (int c = 0; c < C::NH; ++c)
#pragma unroll
        for (int rc = 0; rc < KT / BOX_ROWS; ++rc)
          tma_load_3d(tile + (c * KT + rc * BOX_ROWS) * RB, &map,
                      (1 + kv) * E + h * D + c * C::CW,
                      t * KT + rc * BOX_ROWS, b, full);
      ++g;
    };
    for (int h = 0; h < H; ++h) {
      const int qi = h & 1;
      mbar_wait(q_empty(qi), ((h >> 1) & 1) ^ 1);
      mbar_expect_tx(q_full(qi), S::q_bytes);
#pragma unroll
      for (int c = 0; c < C::NH; ++c)
#pragma unroll
        for (int rc = 0; rc < QB / BOX_ROWS; ++rc)
          tma_load_3d(base + qi * S::q_bytes + (c * QB + rc * BOX_ROWS) * RB,
                      &map, h * D + c * C::CW, q0 + rc * BOX_ROWS, b,
                      q_full(qi));
      for (int t = 0; t < ntk; ++t) {
        load(0, h, t, gk);
        load(1, h, t, gv);
      }
      for (int t = ntk; t < nta; ++t) load(1, h, t, gv);
      for (int t = 0; t < ntk; ++t) {
        if (!hold) load(0, h, t, gk);
        load(1, h, t, gv);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg holds query rows q0 + 64 wg .. + 63 ----
  if constexpr (NC == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        CONSUMER_REGS));
  const int wg = role;
  const int t128 = tid % 128;
  const int lane = tid % 32;
  const int warp = t128 / 32;
  const int quad = lane & 3;
  const int qw0 = q0 + wg * WG_ROWS;
  const int rw = warp * 16 + (lane >> 2);  // row in the wg
  const int row0 = qw0 + rw;
  unsigned char* q8 = sbase + S::q8_off + wg * WG_ROWS * D;
  unsigned char* k8 = sbase + S::k8_off;  // both warpgroups' K8 and V8^T
  unsigned char* v8 = sbase + S::v8_off;
  float* fw = reinterpret_cast<float*>(sbase + S::f_off);
  float* sqs = fw + wg * WG_ROWS;  // [64] this warpgroup's q scales
  float* ksb = fw + QB;            // [2][128] key scales, by tile parity
  float* sv = ksb + 2 * KT;        // [D] v's column scales
  float* rsv = sv + D;             // [D] their reciprocals
  float* vpart = rsv + D;          // [4 NC][D] the warps' column maxima
  // the int8 operands' descriptors (unswizzled core matrices, see cm_off);
  // a k32 step moves the start by two core matrices, 256 bytes
  const uint64_t dq = smem_desc(base + S::q8_off + wg * WG_ROWS * D, 128,
                                8 * D, 0);
  const uint64_t dk = smem_desc(base + S::k8_off, 128, 8 * D, 0);
  const uint64_t dv = smem_desc(base + S::v8_off, 128, 8 * KT, 0);
  auto wg_sync = [&]() { named_bar(BAR_WG + wg, 128); };
  // every consumer thread of the block
  auto all_sync = [&]() {
    if constexpr (NC == 2)
      named_bar(BAR_SCHED, 256);
    else
      named_bar(BAR_WG, 128);
  };

  uint32_t s[KT / 2];   // S (s32) of a key tile, the m64n128 layout
  uint32_t s1[KT / 2];  // with hold, the second key tile's S
  uint32_t o[D / 2];    // P8 . V8 (s32)
  uint32_t p[KT / 8];   // P8 as 8-bit A fragments, 4 a k32 step
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) s[i] = s1[i] = 0u;
#pragma unroll
  for (int i = 0; i < KT / 8; ++i) p[i] = 0u;
  float amax[2] = {0.0f, 0.0f};  // emission: the two rows' running absmax
  int gk = 0, gv = 0;

  // K tile gk: quantized into K8 and its key scales (NC threads a key,
  // the warpgroups half the keys each), then its ring stage goes back;
  // returns the key scales. With sync, every warp's scores of the last
  // tile are done before K8 is rewritten (pass A has no other barrier
  // between them).
  auto take_k = [&](bool sync) {
    if (sync) all_sync();
    const int st = gk % STAGES;
    mbar_wait(k_full(st), (gk / STAGES) & 1);
    float* ks = ksb + (gk & 1) * KT;
    const int n = wg * (KT / NC) + t128 / NC;
    const float sc = quant_row<D, KT>(sbase + S::k_off + st * C::TILE_BYTES,
                                      n, (t128 % NC) * (D / NC), D / NC, NC,
                                      k8, n);
    if (t128 % NC == 0) ks[n] = sc;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    all_sync();
    if (lane == 0) mbar_arrive(k_empty(st));
    ++gk;
    return static_cast<const float*>(ks);
  };
  // acc = Q8 . K8^T: D/32 k32 steps, both operands in shared memory
  auto issue_scores = [&](uint32_t* acc) {
    fence_regs<KT / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk)
      wgmma_s8_m64n128k32(acc, dq + ((kk * 256) >> 4),
                          dk + ((kk * 256) >> 4), kk > 0);
    wgmma_commit();
  };
  // V tile gv's ring stage, once this warp is done with it
  auto release_v = [&]() {
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty(gv % STAGES));
    ++gv;
  };
  auto v_tile = [&]() {
    const int st = gv % STAGES;
    mbar_wait(v_full(st), (gv / STAGES) & 1);
    return sbase + S::v_off + st * C::TILE_BYTES;
  };
  // the score of accumulator i = 4j + 2r + e (value v) of the key tile at
  // k0 (key k0 + 8j + 2 quad + e): -1e30 past len where MASKED (the tile
  // that holds len, and every tile of a len-0 row)
  auto score = [&](auto masked, const float* ks, const float* qs2, int k0,
                   int i, uint32_t v) {
    const int col = 8 * (i >> 2) + 2 * quad + (i & 1);
    const float sc =
        __fmul_rn(__fmul_rn(i2f_small(v), qs2[(i >> 1) & 1]), ks[col]);
    if constexpr (decltype(masked)::value) return k0 + col < len ? sc : -1e30f;
    return sc;
  };
  // is key tile t wholly inside len (so no key of it is masked)?
  auto inside = [&](int t) { return (t + 1) * KT <= len; };
  // pass A on K tile t, its scores into acc: the row max goes on in m (two
  // partial maxima a row), v's column absmax in vmax; returns the tile's
  // key scales
  auto tile_a = [&](uint32_t* acc, int t, float* m, float* vmax,
                    const float* qs2) {
    const float* ks = take_k(true);
    issue_scores(acc);
    vmax_tile<D, NT>(v_tile(), tid, vmax);
    release_v();
    wgmma_wait<0>();
    fence_regs<KT / 2>(acc);
    auto row_max = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        const int col = 8 * (i >> 2) + 2 * quad + (i & 1);
        const int k = ((i >> 1) & 1) + 2 * ((i >> 2) & 1);
        const float sc = score(masked, ks, qs2, t * KT, i, acc[i]);
        if (!decltype(masked)::value || t * KT + col < L)
          m[k] = fmaxf(m[k], sc);
      }
    };
    if (inside(t))
      row_max(std::false_type{});
    else
      row_max(std::true_type{});
    return ks;
  };
  // pass B on K tile t: its scores in acc (HELD: kept from pass A, with
  // its key scales ks; else computed again here); p8 in place of each
  // score, their row sums in den, then o += P8 . V8. The keys of V8^T are
  // permuted so that this thread's own S accumulators are its P8 A
  // fragments: k32 step kk's register 2c + r (c: its 16-byte half, r: row
  // r0 or r0 + 8) holds accumulator chunks j = 4kk + 2c and j + 1, their
  // pairs 2 quad, 2 quad + 1 in bytes 0, 1 and 2, 3: keys 8j + 2 quad +
  // {0, 1, 8, 9}, which quant_v stores at A positions 32kk + 16c + 4 quad
  // + {0, 1, 2, 3} of V8^T.
  auto tile_b = [&](auto held, uint32_t* acc, int t, const float* ks,
                    const float* m, uint32_t* den, const float* qs2) {
    if constexpr (decltype(held)::value) {
      if (t > 0) all_sync();  // every warp's P8 . V8 of tile 0 is done
    } else {
      ks = take_k(false);
      issue_scores(acc);
    }
    quant_v<D, NT>(v_tile(), tid, rsv, v8);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    release_v();
    if constexpr (!decltype(held)::value) wgmma_wait<0>();
    fence_regs<KT / 2>(acc);
    fence_regs<KT / 8>(p);
    // p8 as rint_bits (p8 in the low byte); keys past L none (the bias)
    auto probs = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        const int col = 8 * (i >> 2) + 2 * quad + (i & 1);
        const float x = __fadd_rn(
            __fsub_rn(score(masked, ks, qs2, t * KT, i, acc[i]),
                      m[(i >> 1) & 1]),
            LOG2_127);
        acc[i] = rint_bits(ex2(x));
        if (decltype(masked)::value && t * KT + col >= L) acc[i] = 0x4B400000u;
        den[((i >> 1) & 1) + 2 * ((i >> 2) & 1)] += acc[i];
      }
    };
    if (inside(t))
      probs(std::false_type{});
    else
      probs(std::true_type{});
#pragma unroll
    for (int w = 0; w < KT / 8; ++w) {
      const int j = 2 * (w >> 1), r = w & 1;
      p[w] = pack_bytes(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1],
                        acc[4 * j + 4 + 2 * r], acc[4 * j + 4 + 2 * r + 1]);
    }
    all_sync();  // V8^T is complete
    fence_regs<D / 2>(o);
    fence_regs<KT / 8>(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 32; ++kk) {
      const uint64_t db = dv + ((kk * 256) >> 4);
      if constexpr (D == 128)
        wgmma_s8_rs_m64n128k32(o, p + 4 * kk, db, 1);
      else if constexpr (D == 64)
        wgmma_s8_rs_m64n64k32(o, p + 4 * kk, db, 1);
      else
        wgmma_s8_rs_m64n32k32(o, p + 4 * kk, db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(o);
    fence_regs<KT / 8>(p);
  };

  for (int h = 0; h < H; ++h) {
    const int qi = h & 1;
    mbar_wait(q_full(qi), (h >> 1) & 1);
    // this warpgroup's Q rows quantized per row, two threads a row
    {
      const int rr = t128 >> 1, half = t128 & 1;
      const float sc = quant_row<D, QB>(sbase + qi * S::q_bytes,
                                        wg * WG_ROWS + rr, half * (D / 2),
                                        D / 2, 2, q8, rr);
      if (half == 0) sqs[rr] = sc;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync();
    if (lane == 0) mbar_arrive(q_empty(qi));
    const float qs2[2] = {__fmul_rn(sqs[rw], a.s2),
                          __fmul_rn(sqs[rw + 8], a.s2)};

    // pass A: the row max m over keys < L, and v's column absmax over L
    float m[4] = {-3.0e38f, -3.0e38f, -3.0e38f, -3.0e38f};
    float vmax[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) vmax[i] = 0.0f;
    const float* ks0 = nullptr;
    const float* ks1 = nullptr;
    if (hold) {
      ks0 = tile_a(s, 0, m, vmax, qs2);
      if (ntk == 2) ks1 = tile_a(s1, 1, m, vmax, qs2);
    } else {
      for (int t = 0; t < ntk; ++t) tile_a(s, t, m, vmax, qs2);
    }
    for (int t = ntk; t < nta; ++t) {
      vmax_tile<D, NT>(v_tile(), tid, vmax);
      release_v();
    }
    m[0] = quad_max(fmaxf(m[0], m[2]));
    m[1] = quad_max(fmaxf(m[1], m[3]));
    // v's column scales: over the lanes of a column group, the warps, then
    // the reciprocal once
#pragma unroll
    for (int off = G; off < 32; off <<= 1)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        vmax[i] = fmaxf(vmax[i], __shfl_xor_sync(0xffffffffu, vmax[i], off));
    if (lane < G)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        vpart[(tid / 32) * D + 8 * lane + i] = vmax[i];
    all_sync();
    if (tid < D) {
      float mx = 0.0f;
#pragma unroll
      for (int w = 0; w < 4 * NC; ++w) mx = fmaxf(mx, vpart[w * D + tid]);
      sv[tid] = fmaxf(mx, 1e-30f) * INV127;
      rsv[tid] = 1.0f / sv[tid];
    }
    all_sync();

    // pass B: p8 = rint(exp2(s - m + log2 127)) in [0, 127]; o += p8 . v8;
    // den: the row sums of 12582912 + p8 over 32 keys a tile (two partial
    // sums a row), modulo 2^32: the bias comes off at the end
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0u;
    uint32_t den[4] = {0u, 0u, 0u, 0u};
    if (hold) {
      tile_b(std::true_type{}, s, 0, ks0, m, den, qs2);
      if (ntk == 2) tile_b(std::true_type{}, s1, 1, ks1, m, den, qs2);
    } else {
      for (int t = 0; t < ntk; ++t)
        tile_b(std::false_type{}, s, t, nullptr, m, den, qs2);
    }

    // out = (f32(o) * sv) * (127 / max(f32(127 * den), 1))
    float r127[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int d = (int)(den[r] + den[r + 2] -
                    (uint32_t)(KT / 4 * ntk) * 0x4B400000u);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      r127[r] = 127.0f / fmaxf((float)(d * 127), 1.0f);
    }
    store_head<D, EMIT>(a, b, L, row0, h, quad, amax, [&](int r, int i) {
      const int col = 8 * (i >> 2) + 2 * quad + (i & 1);
      return __fmul_rn(__fmul_rn((float)(int)o[i], sv[col]), r127[r]);
    });
  }

  if constexpr (EMIT != EMIT_NO)
    emit_rows<EMIT>(a, reinterpret_cast<float*>(sbase + S::rmax_off) +
                           wg * WG_ROWS,
                    amax, tid, quad, rw, L, qw0, b, E);
}

// rows of bf16 [B*R, ld] (row stride ld, 16-byte aligned) as a 3-D tensor
// [B, R, cols], read in boxes of CW columns x 64 rows x 1 sequence,
// swizzled to the box row's width (rows past R read as zeros): qkv [B, L,
// 3E], or the CP layout's q [B, Lc, E] (ldq) and kv [B, L, 2E]
cudaError_t rows_map(CUtensorMap* map, const void* ptr, int B, int R,
                     int cols, int ld, int cw) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)R, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2,
                                 (cuuint64_t)ld * 2 * (cuuint64_t)R};
  const cuuint32_t box[3] = {(cuuint32_t)cw, (cuuint32_t)BOX_ROWS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cw * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// mode 3's bias [H, L, L] f32 as boxes of 32 keys x 64 rows x 1 head,
// 128-byte swizzled (rows and keys past L read as zeros)
cudaError_t bias_map(CUtensorMap* map, const void* bias, int L, int H) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)L, (cuuint64_t)L, (cuuint64_t)H};
  const cuuint64_t strides[2] = {(cuuint64_t)L * 4,
                                 (cuuint64_t)L * 4 * (cuuint64_t)L};
  const cuuint32_t box[3] = {BIAS_COLS, (cuuint32_t)WG_ROWS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(bias), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// mode 1's seg [B, L] int32 as boxes of 128 keys x 1 sequence, unswizzled
// (keys past L read as zeros)
cudaError_t seg_map(CUtensorMap* map, const void* seg, int B, int L) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[1] = {(cuuint64_t)L * 4};
  const cuuint32_t box[2] = {KT, 1};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<void*>(seg), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// one launch on the Q and K/V maps given: grid (query tiles, H, B), (B,
// query tiles, H) for mode 3 with a large bias, B x query tiles where a
// block runs every head
template <int D, int MODE, int NC, int EMIT = EMIT_NO, int CP = 0>
cudaError_t launch_maps(const CUtensorMap& qmap, const CUtensorMap& kvmap,
                        const void* bias, const Args& a, int B,
                        cudaStream_t stream) {
  using S = Smem<D, NC, MODE, EMIT>;
  // (a mode that reads no bias or segment ids gets the Q map in their
  // place)
  CUtensorMap bmap = qmap, smap = qmap;
  cudaError_t err = cudaSuccess;
  if (MODE == BIAS) err = bias_map(&bmap, bias, a.L, a.H);
  if (seg_mode(MODE)) err = seg_map(&smap, a.seg, B, a.L);
  if (err != cudaSuccess) return err;
  auto kern = attn_sm90_kernel<D, MODE, NC, EMIT, CP>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)S::bytes);
  if (err != cudaSuccess) return err;
  const int nqb = (a.Lq + S::QB - 1) / S::QB;
  const dim3 grid = all_heads(MODE, EMIT)            ? dim3(nqb * B)
                    : MODE == BIAS && a.batch_fastest ? dim3(B, nqb, a.H)
                                                      : dim3(nqb, a.H, B);
  kern<<<grid, 128 * (NC + 1), S::bytes, stream>>>(qmap, kvmap, bmap, smap,
                                                   a);
  return cudaGetLastError();
}

// the fused layout: q, k and v from one map of qkv [B, L, 3E]
template <int D, int MODE, int NC, int EMIT = EMIT_NO>
cudaError_t launch(const void* qkv, const void* bias, const Args& a, int B,
                   cudaStream_t stream) {
  CUtensorMap map;
  const cudaError_t err = rows_map(&map, qkv, B, a.L, 3 * a.H * D,
                                   3 * a.H * D, Cfg<D, MODE>::CW);
  if (err != cudaSuccess) return err;
  return launch_maps<D, MODE, NC, EMIT>(map, map, bias, a, B, stream);
}

template <int D>
cudaError_t launch_mode(int mode, const void* qkv, const void* bias,
                        const Args& a, int B, cudaStream_t stream) {
  // one consumer warpgroup where a row fits in 64 queries (K2's, K4's and
  // K7's short rows); the streamed modes take L % 128 == 0
  const bool one = a.L <= WG_ROWS;
  switch (mode) {
    case PREFIX:
      return one ? launch<D, PREFIX, 1>(qkv, bias, a, B, stream)
                 : launch<D, PREFIX, 2>(qkv, bias, a, B, stream);
    case SEGMENT:
      return one ? launch<D, SEGMENT, 1>(qkv, bias, a, B, stream)
                 : launch<D, SEGMENT, 2>(qkv, bias, a, B, stream);
    case WINDOW:  // L % 128 == 0: two warpgroups, one 128-row block
      return launch<D, WINDOW, 2>(qkv, bias, a, B, stream);
    case BIAS:
      return one ? launch<D, BIAS, 1>(qkv, bias, a, B, stream)
                 : launch<D, BIAS, 2>(qkv, bias, a, B, stream);
    case STREAM: return launch<D, STREAM, 2>(qkv, bias, a, B, stream);
    case ALIBI: return launch<D, ALIBI, 2>(qkv, bias, a, B, stream);
    case BAND:  // L % 128 == 0: two warpgroups, one 128-row block
      return launch<D, BAND, 2>(qkv, bias, a, B, stream);
    case CAUSAL: return launch<D, CAUSAL, 2>(qkv, bias, a, B, stream);
    case CAUSAL_ALIBI:
      return launch<D, CAUSAL_ALIBI, 2>(qkv, bias, a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// K2e / K4e: modes 0 and 1 with emission, one or two consumer warpgroups
template <int D, int MODE>
cudaError_t launch_emit(int emit, const void* qkv, const Args& a, int B,
                        cudaStream_t stream) {
  const bool one = a.L <= WG_ROWS;
  if (emit == EMIT_BOTH)
    return one ? launch<D, MODE, 1, EMIT_BOTH>(qkv, nullptr, a, B, stream)
               : launch<D, MODE, 2, EMIT_BOTH>(qkv, nullptr, a, B, stream);
  return one ? launch<D, MODE, 1, EMIT_ONLY>(qkv, nullptr, a, B, stream)
             : launch<D, MODE, 2, EMIT_ONLY>(qkv, nullptr, a, B, stream);
}

template <int D>
cudaError_t launch_emit_mode(int mode, int emit, const void* qkv,
                             const Args& a, int B, cudaStream_t stream) {
  return mode == PREFIX ? launch_emit<D, PREFIX>(emit, qkv, a, B, stream)
                        : launch_emit<D, SEGMENT>(emit, qkv, a, B, stream);
}

// K8a / K8b: mode 4 in the CP layout, one consumer warpgroup where Lc <=
// 64, else two
template <int D>
cudaError_t launch_cp(const void* q, const void* kv, const Args& a, int B,
                      int ldq, cudaStream_t stream) {
  constexpr int CW = Cfg<D, STREAM>::CW;
  const int E = a.H * D;
  CUtensorMap qmap, kvmap;
  cudaError_t err = rows_map(&qmap, q, B, a.Lq, E, ldq, CW);
  if (err != cudaSuccess) return err;
  err = rows_map(&kvmap, kv, B, a.L, 2 * E, 2 * E, CW);
  if (err != cudaSuccess) return err;
  return a.Lq <= WG_ROWS ? launch_maps<D, STREAM, 1, EMIT_NO, 1>(
                              qmap, kvmap, nullptr, a, B, stream)
                        : launch_maps<D, STREAM, 2, EMIT_NO, 1>(
                              qmap, kvmap, nullptr, a, B, stream);
}


// MLA: mode 7 at q / k heads D and v heads DV wide, from one map of qkv
// [B, L, H*(2D + DV)]; grid (query tiles, H, B), the last query tile first
template <int D, int DV>
cudaError_t launch_mla(const void* qkv, const Args& a, int B,
                       cudaStream_t stream) {
  using S = Smem<D, 2, CAUSAL, EMIT_NO, DV>;
  const int W = a.H * (2 * D + DV);
  CUtensorMap map;
  cudaError_t err =
      rows_map(&map, qkv, B, a.L, W, W, Cfg<D, CAUSAL, DV>::CW);
  if (err != cudaSuccess) return err;
  auto kern = attn_sm90_kernel_mla<D, DV>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)S::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.L + S::QB - 1) / S::QB, a.H, B);
  kern<<<grid, 384, S::bytes, stream>>>(map, a);
  return cudaGetLastError();
}

// K2i8: one consumer warpgroup where L <= 64, else two; a block per
// (query tile, sequence), the last sequence first
template <int D, int NC, int EMIT>
cudaError_t launch_i8(const void* qkv, const Args& a, int B,
                      cudaStream_t stream) {
  using S = I8Smem<D, NC, EMIT>;
  CUtensorMap map;
  cudaError_t err = rows_map(&map, qkv, B, a.L, 3 * a.H * D, 3 * a.H * D,
                             I8Cfg<D>::CW);
  if (err != cudaSuccess) return err;
  auto kern = attn90_i8_kernel<D, NC, EMIT>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)S::bytes);
  if (err != cudaSuccess) return err;
  const int nqb = (a.L + S::QB - 1) / S::QB;
  kern<<<nqb * B, 128 * (NC + 1), S::bytes, stream>>>(map, a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_i8_emit(int emit, const void* qkv, const Args& a, int B,
                           cudaStream_t stream) {
  const bool one = a.L <= WG_ROWS;
  switch (emit) {
    case EMIT_NO:
      return one ? launch_i8<D, 1, EMIT_NO>(qkv, a, B, stream)
                 : launch_i8<D, 2, EMIT_NO>(qkv, a, B, stream);
    case EMIT_BOTH:
      return one ? launch_i8<D, 1, EMIT_BOTH>(qkv, a, B, stream)
                 : launch_i8<D, 2, EMIT_BOTH>(qkv, a, B, stream);
    case EMIT_ONLY:
      return one ? launch_i8<D, 1, EMIT_ONLY>(qkv, a, B, stream)
                 : launch_i8<D, 2, EMIT_ONLY>(qkv, a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// qkv [B*L, 3*H*D] bf16 (16-byte aligned), lengths [B] int32 (modes 0,
// 3-8), seg [B, L] int32 (modes 1 and 2, -1 on pads), kbs, kbe [B, L/128]
// int32 (mode 2: each 128-row query block's first and last key block,
// block_ranges) and W (mode 2: the key-block cap, >= 1; mode 6: window //
// 2, >= 0), slopes [H] f32 (modes 5 and 8), bias [H, L, L] f32 (mode 3,
// log2-scaled, 16-byte aligned), out [B*L, H*D] bf16, all device pointers
// (a mode's unused ones may be null). mode: 0 (K2), 1 (K4), 2 (K5; L %
// 128 == 0), 3 (K7), 4, 5 (K6 plain, ALiBi), 6 (K6w; L % 128 == 0), 7
// (K6c), 8 (K6ca). D: 32, 64 or 128; L % 8 == 0. s2 = log2(e)/sqrt(D) as
// f32; hi = the score clamp bound. Returns a cudaError_t.
int attn90_launch(const void* qkv, const void* lengths, const void* seg,
                  const void* kbs, const void* kbe, const void* slopes,
                  const void* bias, void* out, int mode, int B, int L, int H,
                  int D, int W, float s2, float hi, void* stream) {
  if (B < 0 || L <= 0 || L % 8 || H <= 0) return cudaErrorInvalidValue;
  if (alibi_mode(mode) && slopes == nullptr) return cudaErrorInvalidValue;
  if (mode == BIAS && bias == nullptr) return cudaErrorInvalidValue;
  if (seg_mode(mode) != (seg != nullptr)) return cudaErrorInvalidValue;
  if (!seg_mode(mode) && lengths == nullptr) return cudaErrorInvalidValue;
  if (mode == WINDOW &&
      (kbs == nullptr || kbe == nullptr || W < 1 || L % KT))
    return cudaErrorInvalidValue;
  if (mode == BAND && (W < 0 || L % KT)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  Args a{};
  a.lengths = static_cast<const int*>(lengths);
  a.seg = static_cast<const int*>(seg);
  a.kbs = static_cast<const int*>(kbs);
  a.kbe = static_cast<const int*>(kbe);
  // (mode 6: a half window past L keeps every key of the row, |i - j| < L)
  a.W = mode == BAND && W > L ? L : W;
  a.slopes = static_cast<const float*>(slopes);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.L = a.Lq = L;
  a.H = H;
  a.s2 = s2;
  a.hi = hi;
  a.batch_fastest = mode == BIAS && 4ull * H * L * L > BIAS_L2_BYTES;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_mode<32>(mode, qkv, bias, a, B, st);
    case 64: return launch_mode<64>(mode, qkv, bias, a, B, st);
    case 128: return launch_mode<128>(mode, qkv, bias, a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

// K2e (mode 0) and K4e (mode 1): attention with its context quantized per
// row over all H*D columns. qkv, out as in attn90_launch; mode 0 reads
// lengths [B] int32, mode 1 seg [B, L] int32 (-1 on pads; 16-byte
// aligned). emit 1 ("both") writes out, o8 [B*L, H*D] int8
// and os [B*L] f32; emit 2 ("only") writes o8 and os and takes scratch
// [B*L, H*D] f32 (its contents are left undefined), out may be null. All
// 16-byte aligned device pointers; H*D % 32 == 0. Returns a cudaError_t.
int attn90_emit_launch(const void* qkv, const void* lengths, const void* seg,
                       void* out, void* o8, void* os, void* scratch,
                       int mode, int emit, int B, int L, int H, int D,
                       float s2, float hi, void* stream) {
  if (B < 0 || L <= 0 || L % 8 || H <= 0 || (H * D) % 32)
    return cudaErrorInvalidValue;
  if ((mode != PREFIX && mode != SEGMENT) ||
      (emit != EMIT_BOTH && emit != EMIT_ONLY))
    return cudaErrorInvalidValue;
  if ((mode == PREFIX && lengths == nullptr) ||
      (mode == SEGMENT && seg == nullptr) || o8 == nullptr ||
      os == nullptr || (emit == EMIT_BOTH && out == nullptr) ||
      (emit == EMIT_ONLY && scratch == nullptr))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  Args a{};
  a.lengths = static_cast<const int*>(lengths);
  a.seg = static_cast<const int*>(seg);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.o8 = static_cast<int8_t*>(o8);
  a.os = static_cast<float*>(os);
  a.scratch = static_cast<float*>(scratch);
  a.L = a.Lq = L;
  a.H = H;
  a.s2 = s2;
  a.hi = hi;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_emit_mode<32>(mode, emit, qkv, a, B, st);
    case 64: return launch_emit_mode<64>(mode, emit, qkv, a, B, st);
    case 128: return launch_emit_mode<128>(mode, emit, qkv, a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

// K8a / K8b: mode 4 in the CP layout. q [B*Lc, H*D] bf16 with row stride
// ldq (ldq % 8 == 0, ldq >= H*D, 16-byte aligned: a column slice of a
// [B*Lc, 3*H*D] projection is taken in place), kv [B*L, 2*H*D] bf16 (k |
// v, 16-byte aligned), lengths [B] int32 (prefix lengths of the gathered
// row), out [B*Lc, H*D] bf16; all device pointers. D: 32, 64 or 128; Lc %
// 8 == 0, L % 8 == 0. s2 = log2(e)/sqrt(D) as f32; hi = the score clamp
// bound, sized to the L gathered keys. Returns a cudaError_t.
int attn90_cp_launch(const void* q, const void* kv, const void* lengths,
                     void* out, int B, int Lc, int L, int H, int D, int ldq,
                     float s2, float hi, void* stream) {
  if (B < 0 || Lc <= 0 || Lc % 8 || L <= 0 || L % 8 || H <= 0 ||
      ldq % 8 || ldq < H * D)
    return cudaErrorInvalidValue;
  if (q == nullptr || kv == nullptr || lengths == nullptr || out == nullptr)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  Args a{};
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.L = L;
  a.Lq = Lc;
  a.H = H;
  a.s2 = s2;
  a.hi = hi;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_cp<32>(q, kv, a, B, ldq, st);
    case 64: return launch_cp<64>(q, kv, a, B, ldq, st);
    case 128: return launch_cp<128>(q, kv, a, B, ldq, st);
    default: return cudaErrorInvalidValue;
  }
}

// K2i8 (mode 0 with int8 scores): qkv [B*L, 3*H*D] bf16, lengths [B]
// int32; emit 0 writes out [B*L, H*D] bf16, 1 ("both") also o8 [B*L, H*D]
// int8 and os [B*L] f32, 2 ("only") o8 and os alone through scratch
// [B*L, H*D] f32 (its contents left undefined; out may be null). All
// 16-byte aligned device pointers; D: 32, 64 or 128; L % 8 == 0; with
// emission H*D % 32 == 0. s2 = log2(e)/sqrt(D) as f32. Returns a
// cudaError_t.
int attn90_i8_launch(const void* qkv, const void* lengths, void* out,
                     void* o8, void* os, void* scratch, int emit, int B,
                     int L, int H, int D, float s2, void* stream) {
  if (B < 0 || L <= 0 || L % 8 || H <= 0 || lengths == nullptr)
    return cudaErrorInvalidValue;
  if ((emit != EMIT_ONLY && out == nullptr) ||
      (emit != EMIT_NO && (o8 == nullptr || os == nullptr ||
                           (H * D) % 32)) ||
      (emit == EMIT_ONLY && scratch == nullptr))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  Args a{};
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.o8 = static_cast<int8_t*>(o8);
  a.os = static_cast<float*>(os);
  a.scratch = static_cast<float*>(scratch);
  a.L = a.Lq = L;
  a.H = H;
  a.s2 = s2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_i8_emit<32>(emit, qkv, a, B, st);
    case 64: return launch_i8_emit<64>(emit, qkv, a, B, st);
    case 128: return launch_i8_emit<128>(emit, qkv, a, B, st);
    default: return cudaErrorInvalidValue;
  }
}

// MLA (K6c at DeepSeek-V2's widths): qkv [B*L, H*(2D + DV)] bf16 (16-byte
// aligned) holding q | k | v (q at h*D, k at H*D + h*D, v at 2H*D +
// h*DV), lengths [B] int32, out [B*L, H*DV] bf16, device pointers; mode 7's
// causal prefix mask; (D, DV) = (192, 128); L % 128 == 0; s2 = the softmax
// scale times log2(e) as f32; hi = the score clamp bound. Returns a
// cudaError_t.
int attn90_mla_launch(const void* qkv, const void* lengths, void* out, int B,
                      int L, int H, int D, int DV, float s2, float hi,
                      void* stream) {
  if (B < 0 || L <= 0 || L % KT || H <= 0 || lengths == nullptr)
    return cudaErrorInvalidValue;
  if (D != 192 || DV != 128) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  Args a{};
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.L = a.Lq = L;
  a.H = H;
  a.s2 = s2;
  a.hi = hi;
  return launch_mla<192, 128>(qkv, a, B, static_cast<cudaStream_t>(stream));
}

const char* attn90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
