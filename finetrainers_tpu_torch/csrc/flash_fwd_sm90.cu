// Flash attention forward K1 and its variants K7a (two-pass), K7c (two-level)
// and K7b (skewed) for Hopper (sm_90a), CUDA C++: warp-specialised kernels
// whose products run on wgmma, fed by TMA through a ring of shared-memory
// stages.
//
// Replaces: finetrainers_tpu/ops/flash_attention.py::_fwd_kernel (:106; Pallas,
// TPU), driven there by _flash_forward (:689) through pallas_call (:852);
// ::_fwd_kernel_twopass (K7a, :337), _fwd_kernel's `two_level` branch (K7c,
// :229-246, :266-285) and ::_fwd_kernel_skew (K7b, :491), which _flash_forward
// picks under FINETRAINERS_FLASH_TWOPASS, _TWOLEVEL and _SKEW. K1 computes that
// function on the operands of the pre-pass (`rope_prep_kernel` in
// flash_bwd.cu, which the wrapper launches first): q_s = T(rope(q) * scale *
// log2(e)) and k_r = T(rope(k)), T() rounding to the input dtype. Then, in base 2:
//   s = q_s k_r^T (fp32), selected to -1e30 at keys >= kv_lens[b];
//   m_new = max(m, rowmax(s)); p = exp2(s - m_new); alpha = exp2(m - m_new);
//   l = l*alpha + rowsum(p); acc = acc*alpha + T(p) v;
//   out = T(acc / l) and the natural-log lse = m*ln2 + log(l); a row with no
//   valid key gives out 0 and lse -1e30*ln2.
// K7a computes the same quantities in two passes over the key tiles: pass A
// takes the row max m of s only; pass B recomputes s with the same products,
// so s - m <= 0 exactly, and accumulates p = exp2(s - m) (selected to 0 at
// keys >= kv_lens[b]) into l and acc with no rescale; out and lse as K1.
// K7c (on the pre-pass's operands) takes p against each 128-key tile's own max:
//   m_cur = rowmax(s); p = exp2(s - m_cur); m_new = max(m, m_cur);
//   alpha = exp2(m - m_new); beta = exp2(m_cur - m_new);
//   l = l*alpha + rowsum(p)*beta; acc = acc*alpha + (T(p) v)*beta.
// K7b takes no RoPE tables and no pre-pass: q_s = T(q * scale * log2(e)) is
// made in shared memory, then K1's step runs on each tile (the TPU kernel runs
// it on tile j-1 while tile j's QK^T is issued; so does this one).
//
// What bounds them on this card: at LTX's self-attention shape (B=2, N=32,
// S=2688, H=64) QK^T plus PV is 4*B*N*S*S*H = 118 GFLOP per call, against ~88
// MB of q_s, k_r, v and out (~132 MB with the fp32 RoPE tables the pre-pass
// reads): 900-1,340 operations per byte, far above the H100's ~295 FLOP/byte
// ridge; Wan's shape (S=19,968, H=128) is further above it, and Wan's
// cross-attention (Skv = 512) still at ~500. So they are bound by operations,
// and the tensor cores are the resource to feed. K7a does 1.5x K1's score
// products; K7c's and K7b's products are K1's.
//
// What this design does about it:
//  - The rotation and the q scaling run once per call, in the pre-pass, not
//    once per CTA on every k tile (the mma.sync K1 this replaces re-rotated all
//    of k in each of the S/128 CTAs of a head: ~42% of its time at Wan's shape).
//  - One CTA owns a q tile of one (batch, head): warpgroup 0 gives up its
//    registers (setmaxnreg) and one of its threads issues every TMA load; the
//    consumer warpgroups own 64 q rows each and run both products as wgmma,
//    the only path to the tensor cores' full rate. K1 and K7a: at H=128 two
//    consumers (128 rows, 240 registers each); at H=64 three (192 rows, 160
//    each). K7c and K7b: two at both.
//  - Shared memory holds the q tile, loaded once, and a ring of kStages k/v
//    stages of 128 keys, each with a full and an empty mbarrier, so the next
//    tiles load while the current one is computed. TMA writes them with the
//    128-byte swizzle that wgmma reads without bank conflicts. The operands are
//    described by rank-4 tensor maps (H, S, N, B) over their strides, so a BNSH
//    view of a BTNH buffer is read where it lies; TMA fills rows past S with 0.
//  - S = q_s k_r^T is wgmma m64n128k16 with both operands in shared memory
//    (K-major: H is contiguous). The softmax recurrence runs in fp32 registers
//    on the accumulator fragments; p, rounded to T, stays in registers as the A
//    operand of P V (m64nHk16, v from shared memory, MN-major).
//  - At H=32 a row of q, k or v is 64 bytes: TMA writes each tile as one box
//    under the 64-byte swizzle, the descriptors take that layout (8-row groups
//    512 bytes apart; a row offset, as K7b's second 64-key half or a consumer's
//    q rows, steps 64 bytes a row), QK^T is two k16 steps and P V is m64n32k16,
//    with K1's and K7a's three consumers as at H=64 (K7c's and K7b's two). A score there costs 128 tensor flops but one
//    exponential, so the SFU's ~16 exp2 per SM per clock, not the tensor
//    cores, bound the kernel (PERF.md).
//  - Inside a warpgroup, tile t's QK^T is issued together with tile t-1's P V,
//    and tile t's softmax runs while that P V is still on the tensor cores; the
//    two warpgroups run unsynchronised, so one's softmax also overlaps the
//    other's products. This measured 10-20% faster than waiting for each
//    product in turn, and 2 stages faster than 3 (PERF.md).
//  - TMA reads the real rows of k and v between kv_lens[b] and S: the scores of
//    those keys are selected to -1e30 before the max, so their p is exactly 0
//    and they add nothing; the producer and the consumers stop at the last tile
//    that holds a valid key.
//  - K7a is K1's kernel with a second sweep: its producer streams pass A's k
//    tiles through all four of the ring's k and v stages, four tiles in
//    flight (a pass-A tile is consumed twice as fast as a pass-B one), then
//    pass B's k and v tiles as K1's does; every barrier expects one tile's
//    bytes. In pass A the consumers hold two score tiles and issue tile t+1's
//    QK^T before taking tile t's max, so the products run back to back; the
//    max is reduced over the quad once, after the pass. Pass B is K1's loop
//    without alpha and the rescale, its step a function of its own
//    (twopass_pv_step): written inline in the consumer with lambdas for the
//    slots, pass B alone ran slower than K1; as it stands, faster. Only
//    the last tile can hold keys past kv_lens[b], so only its steps carry the
//    mask. tools/torch_k5_k7a_variants.py times the choices against their
//    alternatives.
//  - TMA reads the rows of v between kv_lens[b] and the tile's end; K7a zeroes
//    them in shared memory before its last P V, so a NaN there is not
//    multiplied by p = 0 (K1, K7c and K7b give those keys p = 0, which a finite
//    v leaves out).
//  - K7c is K1's kernel (producer, ring, q_s/k_r, store_out) with a product of
//    its own for each tile's p v: acc takes it scaled by beta, so p v cannot
//    accumulate into acc. Its loop is K1's: tile t+1's QK^T is issued with
//    tile t's P V (into pv, 64 floats a thread at H=128, overwritten by its
//    first k-step: wgmma's scale-d = 0, no zeroing pass), tile t+1's max and
//    exponentials run while the P V is on the tensor cores (they need only
//    that tile's max, not m_new), and pv is folded into acc (acc*alpha +
//    pv*beta) after the wait. s (64), pv (64), the packed p (32) and acc (64)
//    fit 240 registers without a spill once the loop's last tile is peeled
//    off into its own instance of the step (two_level_pv_step): with the
//    issues and waits of tile t+1 under a runtime `if`, the same loop spilled
//    28 bytes and ran 1.4x slower. Two consumers at both head dims.
//  - K7b is K1's kernel on the raw q and k. Each consumer warpgroup scales and
//    rounds its own 64 rows of the q tile once, in shared memory, fences them
//    to the async proxy and meets only its own 128 threads at a named barrier;
//    the producer has issued the first k and v tiles with q, so they land
//    meanwhile (at Wan's cross shape a CTA sees only 4 stages, so the prologue
//    is short: one pass over 16 KB of shared memory, then the first QK^T).
//    Its score tiles are 64 keys, half a stage (m64n64, 32 floats a thread).
//    Step u issues tile u's QK^T into one score array, runs K1's softmax step
//    on tile u-1's scores in the other while it is on the tensor cores,
//    rescales acc, packs p, issues tile u-1's P V and waits for both. Two
//    128-key score arrays (128 floats) beside acc (64) do not fit: ptxas
//    spilled 288 bytes and serialized the wgmmas (C7512). The TPU kernel's
//    mask recovery (s > -0.5e30) and its first step on a dummy tile (p = 0,
//    alpha = 1) are identities here and are left out. Two consumers at both
//    head dims.
// Tried for K7a and left out, both slower at Wan's training shape: clusters of
// two CTAs that each load half of every k and v tile and multicast it to both
// (though the pair then reads each tile from L2 once), and q's A fragments in
// registers for QK^T. Tried for K7c and K7b and left out (CUDA-event ms, this
// layout's in brackets, tools/torch_k7bc_variants.py on an H100 80GB HBM3 at
// 700 W; PERF.md): K7c's P V in two m64n64 halves into a 32-float pv, the
// first folded while tile t+1's scores are computed, 4.60-4.77 ms at Wan's
// training shape [3.77-3.88]; three consumers at 160 registers at H=64
// (spills 140 bytes; 0.32 ms at LTX's shape [0.37-0.38]); K7b's 128-key score
// tiles (spills 288 bytes; 4.90-5.09 ms at Wan's training shape [4.74-4.78]),
// three consumers at H=64 (spills 44 bytes; 0.33 ms at LTX's shape
// [0.38]), and its P V left in flight into the next step (ptxas serializes
// the wgmmas, C7515; 5.37-5.38 ms [4.74-4.78]).
// K1's branches are built as a library of their own, from
// flash_fwd_branches_sm90.cu, which compiles this file with FLASH_FWD_BRANCHES
// defined (its entry points: the section at the end), so that nvcc compiles
// them beside the kernels above.
// K1's dense-mask branch (`flash_fwd_mask_sm90`; _fwd_kernel's `mask_ref`
// branch, :217-222, with the block map's tile skipping, :304-307) is K1's
// kernel with a list of live key tiles per q tile and a boolean mask:
//  - The wrapper pads the (B, Sq, Skv) mask with zeros to whole q tiles of
//    block_m rows (K1's own tile, not the TPU kernel's) and 128-key tiles, and
//    lists each q tile's live key tiles in order (a tile is live where any of
//    its mask bytes is set), flagging those whose mask is all set.
//  - The producer loads only the listed k and v tiles, and the consumers step
//    through the same list, so both skip the same tiles.
//  - A consumer reads its score fragment's mask bytes (two per row and 8
//    columns) straight from global memory and selects the masked scores to
//    -inf, never adds -1e30 or multiplies by 0/1: a masked key's p is exactly
//    0, and a row with no live key keeps m = -1e30 and l = 0, so it gives out 0
//    and lse -1e30*ln2, as a row past kv_lens does. A tile flagged full reads
//    no mask.
//  - The CTAs take the last q tiles first, over every (batch, head): under a
//    causal mask those have the most live tiles, so the longest CTAs start
//    first and the short ones fill the last wave.
// K1's causal branch (`flash_fwd_causal_sm90`; _fwd_kernel :205-209, its skip
// :300-303) keeps key col where col <= row + (Skv - Sq), and its segment branch
// (`flash_fwd_segment_sm90`; :210-214) where q_seg[row] == kv_seg[col], both
// beside kv_lens. Each is K1's kernel with a select and a shorter loop:
//  - Causal: the CTA's loop ends at the key tile holding its last row's
//    diagonal, so a tile wholly above the diagonal is never loaded; only the
//    tiles the diagonal (or kv_lens[b]) crosses select their scores, by
//    comparing column and row indices.
//  - Segments: the wrapper lists, per q tile, the key tiles whose id range
//    [min, max] meets the q tile's (no pair can match otherwise, whatever the
//    layout, so the skip is exact), flagging those where both tiles hold one
//    id; the producer and the consumers walk that list as in the mask branch.
//    A consumer compares its two rows' ids with each column's (two ids per
//    8-byte load), unless the tile is flagged and holds no key past
//    kv_lens[b].
//  - Both select to -inf, as the mask branch does, so a row with no live key
//    (causal with Sq > Skv, or a segment none of whose keys is in range) gives
//    out 0 and lse -1e30*ln2. CTAs run longest first, as in the mask branch.
// K7c's causal, segment and mask branches and K7a's and K7b's segment
// branches (_fwd_kernel :201-222 with its skips :299-313 under the two-level
// step, _fwd_kernel_twopass :438-442, _fwd_kernel_skew :629-633), built from
// flash_fwd_variant_branches_sm90.cu (this file with
// FLASH_FWD_VARIANT_BRANCHES defined), are the variants' kernels with K1's
// branch loops: the same key-tile lists or diagonal bound (at each kernel's q
// tile: 128 rows for K7c and K7b at both head dims), the same selects to -inf
// (`variant_select`). K7c exponentiates against the tile's own max: a row with
// no live key in a tile keeps m_cur at -2e30, so its p is exp2(-inf) = 0 and
// its beta exp2(-2e30 - m) = 0, never a NaN; its branches run a tile's select
// and step once the previous tile's P V has landed (beside it they spilled).
// K7a's two passes apply the same select, so no dead key sets a row's max.
// K7b's score tile w is the (w % 2)-th 64-key half of list entry w / 2.
// Not yet used: an enforced ping-pong between the two warpgroups, a
// persistent grid, or a TMA store of the output. The Hopper helpers (barriers, TMA,
// wgmma wrappers, descriptors, tensor maps) are in sm90_common.cuh, shared
// with K2, K3 and K5 (flash_bwd_sm90.cu).

#include "sm90_common.cuh"

namespace {

constexpr int kBlockN = 128;  // keys per stage
constexpr int kStages = 2;
constexpr int kProducerRegs = 24;
// A kernel of this file is a (step, select) pair. The step is the softmax
// recurrence: K1's, K7a's two passes, K7c's two levels or K7b's skewed one.
enum Step { kStraight, kTwoPass, kTwoLevel, kSkew };
// The select is the branch: none (keys past kv_lens only), causal, segment ids
// or a dense mask (the codes the wrappers pass, as flash_bwd_sm90.cu's Branch).
enum Select { kNone, kCausal, kSegment, kMasked };
// The selects that walk a per-q-tile list of live key tiles.
__host__ __device__ constexpr bool listed(int sel) { return sel == kMasked || sel == kSegment; }
// A live key tile's entry in the mask branch's list: its index, with kFullTile
// set where every mask byte of the (q tile, key tile) block is set.
constexpr int kFullTile = 1 << 30;
// Consumer warpgroups per CTA, each owning 64 q rows. K1 and K7a: three at
// H=64 and H=32, where the softmax is a larger share of a tile's work and a third
// warpgroup hides more of it (measured ~13% faster at LTX's shape than two);
// two at H=128, where three sets of accumulators would not fit the register
// file. K7c and K7b: two at both, as each holds a second score or product
// fragment that three consumers' 160 registers cannot (see the note above).
template <int HD, int S = kStraight>
__host__ __device__ constexpr int consumer_wgs() {
  if (S == kTwoLevel) return 2;
  if (S == kSkew) return 2;
  return HD <= 64 ? 3 : 2;
}
template <int HD, int S = kStraight>
__host__ __device__ constexpr int block_m() {  // q rows per CTA
  return 64 * consumer_wgs<HD, S>();
}
template <int HD, int S = kStraight>
__host__ __device__ constexpr int threads() {  // warpgroup 0 loads; the others compute
  return 128 * (1 + consumer_wgs<HD, S>());
}
// The consumers' registers after setmaxnreg: what the producer's 128 threads
// give up, shared among them (a multiple of 8).
template <int HD, int S = kStraight>
__host__ __device__ constexpr int consumer_regs() {
  return consumer_wgs<HD, S>() == 3 ? 160 : 240;
}
// A 64-column half of a 128-row tile: 128 rows of 128 bytes, one TMA box (at
// H=32 the whole 128 x 64-byte tile is one box).
constexpr int kHalfBytes = 128 * 128;

// Byte offsets in shared memory (from a 1024-byte aligned base, as the
// 128-byte swizzle needs): the q tile, kStages k tiles, kStages v tiles, then
// the barriers q_full, k_full[kStages], v_full[kStages], k_empty[kStages],
// v_empty[kStages].
template <int HD, int WGS = consumer_wgs<HD>()>
struct Layout {
  static constexpr int kTileBytes = kBlockN * HD * 2;
  static constexpr int kQBytes = 64 * WGS * HD * 2;
  static_assert(TileRow<HD>::kBoxes <= 2 && (TileRow<HD>::kBoxes == 1 || WGS == 2),
                "the q tile's 64-column halves must be kHalfBytes apart");
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBars = kV + kStages * kTileBytes;
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStages);
};

struct Params {
  void* out;
  float* lse;          // (B, N, Sq) contiguous
  const int* kv_lens;  // (B,) or nullptr
  int heads, seq_q, seq_kv;
  int64_t o_sb, o_sn, o_ss;
  float q_scale;  // K7b: the scale * log2(e) it applies to q itself
  // The mask branch: the (B, q_tiles * block_m, kv_tiles * 128) zero-padded
  // boolean mask, and per (b, q tile) the count and list of live key tiles.
  const unsigned char* mask;
  const int* tiles;        // (B, q_tiles, kv_tiles)
  const int* tile_counts;  // (B, q_tiles)
  int q_tiles, kv_tiles;
  // The segment branch (its tile lists as the mask branch's): per batch the
  // ids of the q rows and of the keys, int32, padded past Sq and Skv.
  const int* q_seg;
  const int* kv_seg;
  int64_t q_seg_len, kv_seg_len;
};

// The producer: one thread of warpgroup 0 loads the q tile once, then k and v
// tile t into stage t % kStages once the consumers have released it.
template <int HD, int WGS = consumer_wgs<HD>()>
__device__ __forceinline__ void produce(const CUtensorMap* q_map, const CUtensorMap* k_map, const CUtensorMap* v_map,
                                        uint32_t base, int q0, int n, int b, int num_tiles,
                                        const int* tiles = nullptr) {
  using L = Layout<HD, WGS>;
  const uint32_t q_full = base + L::kBars;
  using R = TileRow<HD>;
  mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
  for (int h = 0; h < R::kBoxes; ++h) tma_load(base + L::kQ + h * kHalfBytes, q_map, q_full, h * R::kCols, q0, n, b);
  int next = tiles != nullptr && num_tiles > 0 ? tiles[0] : 0;  // the mask branch's live tiles, read one ahead
  for (int t = 0; t < num_tiles; ++t) {
    const int st = t % kStages;
    const uint32_t parity = ((t / kStages) & 1) ^ 1;  // the first round finds every stage free
    const int k0 = (tiles == nullptr ? t : next & (kFullTile - 1)) * kBlockN;
    if (tiles != nullptr && t + 1 < num_tiles) next = tiles[t + 1];
    const uint32_t k_full = q_full + 8 * (1 + st), v_full = k_full + 8 * kStages;
    const uint32_t k_empty = v_full + 8 * kStages, v_empty = k_empty + 8 * kStages;
    mbar_wait(k_empty, parity);
    mbar_expect_tx(k_full, L::kTileBytes);
#pragma unroll
    for (int h = 0; h < R::kBoxes; ++h)
      tma_load(base + L::kK + st * L::kTileBytes + h * kHalfBytes, k_map, k_full, h * R::kCols, k0, n, b);
    mbar_wait(v_empty, parity);
    mbar_expect_tx(v_full, L::kTileBytes);
#pragma unroll
    for (int h = 0; h < R::kBoxes; ++h)
      tma_load(base + L::kV + st * L::kTileBytes + h * kHalfBytes, v_map, v_full, h * R::kCols, k0, n, b);
  }
}

// The softmax step on a landed score tile of N keys: keys at or past kv_len
// selected out, the running max m moved on, s overwritten by p = exp2(s - m),
// and the rescale alpha and this tile's row sums returned.
template <int N = kBlockN>
__device__ __forceinline__ void softmax_step(float* s, float* m, float* alpha, float* rowsum, int k0, int kv_len,
                                             int lane) {
  if (k0 + N > kv_len) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      if (k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1) >= kv_len) s[i] = kNegInf;
    }
  }
  float tmax[2] = {2.f * kNegInf, 2.f * kNegInf};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    tmax[0] = fmaxf(tmax[0], fmaxf(s[4 * j], s[4 * j + 1]));
    tmax[1] = fmaxf(tmax[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m[r], tmax[r]);
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    rowsum[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    s[i] = fast_exp2(s[i] - m[(i >> 1) & 1]);
    rowsum[(i >> 1) & 1] += s[i];
  }
}

// The mask branch's select on a landed score tile of N keys from k0: a score
// whose mask byte is 0 becomes -inf, so its p = exp2(-inf - m) is exactly 0
// and it never moves the row max (m starts at -1e30). row0/row1: this
// thread's two mask rows (8 apart); each fragment pair is one 2-byte load.
template <int N = kBlockN>
__device__ __forceinline__ void mask_select(float* s, const unsigned char* row0, const unsigned char* row1, int k0,
                                            int lane) {
  const int c0 = k0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const uint32_t a = *reinterpret_cast<const uint16_t*>(row0 + c0 + 8 * j);
    const uint32_t c = *reinterpret_cast<const uint16_t*>(row1 + c0 + 8 * j);
    if (!(a & 0xffu)) s[4 * j] = -INFINITY;
    if (!(a >> 8)) s[4 * j + 1] = -INFINITY;
    if (!(c & 0xffu)) s[4 * j + 2] = -INFINITY;
    if (!(c >> 8)) s[4 * j + 3] = -INFINITY;
  }
}

// The causal branch's select on a landed score tile of N keys from k0: a key
// past this thread's row's diagonal (row0, row0 + 8, plus `off` = Skv - Sq) or
// at or past kv_len becomes -inf.
template <int N = kBlockN>
__device__ __forceinline__ void causal_select(float* s, int row0, int off, int k0, int kv_len, int lane) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int col = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
    if (col > row0 + 8 * ((i >> 1) & 1) + off || col >= kv_len) s[i] = -INFINITY;
  }
}

// The segment branch's select on a landed score tile of N keys from k0: a
// key whose id differs from this thread's row's (id0, id1 for its two rows)
// or at or past kv_len becomes -inf. `kv_ids`: this batch's key ids; each
// fragment pair's two ids are one 8-byte load.
template <int N = kBlockN>
__device__ __forceinline__ void segment_select(float* s, const int* kv_ids, int id0, int id1, int k0, int kv_len,
                                               int lane) {
  const int c0 = k0 + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int2 ids = *reinterpret_cast<const int2*>(kv_ids + c0 + 8 * j);
    const bool in0 = c0 + 8 * j < kv_len, in1 = c0 + 8 * j + 1 < kv_len;
    if (ids.x != id0 || !in0) s[4 * j] = -INFINITY;
    if (ids.y != id0 || !in1) s[4 * j + 1] = -INFINITY;
    if (ids.x != id1 || !in0) s[4 * j + 2] = -INFINITY;
    if (ids.y != id1 || !in1) s[4 * j + 3] = -INFINITY;
  }
}

// Where a CTA is: (q tile, head, batch). A branch's CTAs take the last q tiles
// first, over every (batch, head), as the CTAs are dispatched in order: under
// a causal mask those have the most live tiles, so the longest CTAs start
// first and the short ones fill the last wave.
struct CtaAt {
  int q_tile, n, b;
};
template <int B>
__device__ __forceinline__ CtaAt cta_at() {
  if constexpr (B == kNone) {
    return {(int)blockIdx.x, (int)blockIdx.y, (int)blockIdx.z};
  } else {
    const int cells = gridDim.y * gridDim.z;
    const int linear = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    return {(int)gridDim.x - 1 - linear / cells, linear % cells % (int)gridDim.y, linear % cells / (int)gridDim.y};
  }
}

// Step t's key tile of this CTA: with a listed select, entry t of its q tile's
// list (the index, with kFullTile where the block needs no select), else t.
template <int B>
__device__ __forceinline__ int tile_entry(const Params& p, int t) {
  if constexpr (listed(B)) {
    const CtaAt c = cta_at<B>();
    return p.tiles[(int64_t)(c.b * p.q_tiles + c.q_tile) * p.kv_tiles + t];
  } else {
    return t;
  }
}

// The select of K7a's, K7b's or K7c's branch B (step S) on a landed score tile
// of N keys: keys from k0 = the entry's tile + `sub` (K7b's second 64-key half
// of a 128-key tile), as K1's branches select them (to -inf; a tile flagged
// full, or that neither the diagonal nor kv_len crosses, selects nothing). A
// consumer warpgroup `cwg` of these kernels holds two score or product
// fragments, so the CTA's place, the rows and their ids are worked out again
// from blockIdx and the parameters on each tile rather than held through the
// loop.
template <int HD, int S, int B, int N = kBlockN>
__device__ __forceinline__ void variant_select(const Params& p, float* s, int entry, int sub, int cwg, int kv_len,
                                               int lane) {
  const CtaAt c = cta_at<B>();
  const int k0 = (entry & (kFullTile - 1)) * kBlockN + sub;
  const int wg_row = c.q_tile * block_m<HD, S>() + 64 * cwg;  // the warpgroup's first row
  const int row0 = wg_row + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  if constexpr (B == kMasked) {
    if (entry & kFullTile) return;
    const int64_t stride = (int64_t)p.kv_tiles * kBlockN;
    const unsigned char* row = p.mask + ((int64_t)c.b * p.q_tiles * block_m<HD, S>() + row0) * stride;
    mask_select<N>(s, row, row + 8 * stride, k0, lane);
  } else if constexpr (B == kSegment) {
    if ((entry & kFullTile) && k0 + N <= kv_len) return;
    const int* q_ids = p.q_seg + c.b * p.q_seg_len;
    segment_select<N>(s, p.kv_seg + c.b * p.kv_seg_len, q_ids[row0], q_ids[row0 + 8], k0, kv_len, lane);
  } else if constexpr (B == kCausal) {
    const int off = p.seq_kv - p.seq_q;
    if (k0 + N - 1 > wg_row + off || k0 + N > kv_len) causal_select<N>(s, row0, off, k0, kv_len, lane);
  }
}

// out = acc / l in T, lse = m*ln2 + log(l) for a consumer warpgroup's 64 q
// rows from row0 (l: this thread's partial row sums, reduced over the quad
// here); a row with no valid key has l = 0: out 0, lse -1e30*ln2.
template <typename T, int HD>
__device__ __forceinline__ void store_out(const Params& p, const float* o, const float* m, float* l, int row0, int n,
                                          int b) {
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  T* out = static_cast<T*>(p.out) + b * p.o_sb + n * p.o_sn;
  row0 += warp * 16 + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.f) l[r] = 1.f;
    const float inv = 1.f / l[r];
    const int row = row0 + 8 * r;
    if (row >= p.seq_q) continue;
    T* orow = out + row * p.o_ss + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + 8 * i) = Ops<T>::pack(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
    if (lane % 4 == 0) p.lse[((int64_t)b * p.heads + n) * p.seq_q + row] = m[r] * kLn2 + logf(l[r]);
  }
}

// A consumer warpgroup (`cwg` 0, 1 or 2) owning q rows q0 + 64*cwg ... Each thread
// holds two rows, (thread % 128) / 4 % 8 + 16 * warp and 8 below it, in the
// wgmma accumulator layout: element 4j+e of a fragment is at column
// 8j + 2*(lane%4) + (e&1) of row lane/4 + 8*(e>=2) of the warp's 16 rows.
// Tile t's QK^T is issued together with tile t-1's P V, and tile t's softmax
// runs while that P V is on the tensor cores.
// B (the branches): in the mask and segment branches tile t is the key tile
// tiles[t], and its scores pass mask_select or segment_select first unless the
// tile is flagged (and, for segments, holds no key past kv_len); in the causal
// branch a tile the diagonal or kv_len crosses passes causal_select. The
// branches' selects cover kv_len, so softmax_step selects nothing there.
template <typename T, int HD, int B = kNone>
__device__ __forceinline__ void consume(const Params& p, uint32_t base, int cwg, int q0, int n, int b, int kv_len,
                                        int num_tiles, const int* tiles = nullptr) {
  using L = Layout<HD>;
  constexpr int kOut = HD / 2;  // accumulator floats per thread: 64 rows x HD / 128 threads
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + cwg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // this thread's first row
  const unsigned char* mask_row = nullptr;
  int64_t mask_stride = 0;
  if constexpr (B == kMasked) {
    mask_stride = (int64_t)p.kv_tiles * kBlockN;
    mask_row = p.mask + ((int64_t)b * p.q_tiles * block_m<HD>() + row0) * mask_stride;
  }
  const int* kv_ids = nullptr;
  int id0 = 0, id1 = 0;
  if constexpr (B == kSegment) {
    kv_ids = p.kv_seg + b * p.kv_seg_len;
    id0 = p.q_seg[b * p.q_seg_len + row0];
    id1 = p.q_seg[b * p.q_seg_len + row0 + 8];
  }
  const int off = p.seq_kv - p.seq_q;  // the causal diagonal's offset
  // Tile t's scores, landed: the branch's select (`entry`: its list entry,
  // read before the scores were waited for), then the softmax step.
  auto step = [&](float* s, float* m, float* alpha, float* rowsum, int t, int entry) {
    int k0 = t * kBlockN;
    if constexpr (B == kMasked) {
      k0 = (entry & (kFullTile - 1)) * kBlockN;
      if (!(entry & kFullTile)) mask_select(s, mask_row, mask_row + 8 * mask_stride, k0, lane);
    } else if constexpr (B == kSegment) {
      k0 = (entry & (kFullTile - 1)) * kBlockN;
      if (!(entry & kFullTile) || k0 + kBlockN > kv_len) segment_select(s, kv_ids, id0, id1, k0, kv_len, lane);
    } else if constexpr (B == kCausal) {
      if (k0 + kBlockN - 1 > q0 + cwg * 64 + off || k0 + kBlockN > kv_len) causal_select(s, row0, off, k0, kv_len, lane);
    }
    softmax_step(s, m, alpha, rowsum, k0, B == kNone ? kv_len : 0x7fffffff, lane);
  };
  auto entry_of = [&](int t) { return listed(B) ? tiles[t] : 0; };
  const uint32_t q_full = base + L::kBars;
  auto k_full = [&](int st) { return q_full + 8 * (1 + st); };
  auto v_full = [&](int st) { return q_full + 8 * (1 + kStages + st); };
  auto k_empty = [&](int st) { return q_full + 8 * (1 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return q_full + 8 * (1 + 3 * kStages + st); };

  float o[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums; reduced over the quad at the end

  const uint32_t q_addr = base + L::kQ + cwg * 64 * TileRow<HD>::kBytes;
  mbar_wait(q_full, 0);
  if (num_tiles > 0) {
    float s[64], alpha[2], rowsum[2];
    uint32_t pa[kBlockN / 16][4];
    int entry = entry_of(0);
    mbar_wait(k_full(0), 0);
    wgmma_fence();
    issue_ss<T, HD, kBlockN, kHalfBytes, kHalfBytes>(s, q_addr, base + L::kK);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<64>(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty(0));
    step(s, m, alpha, rowsum, 0, entry);
    l[0] = rowsum[0];
    l[1] = rowsum[1];
    pack_a<T, kBlockN>(pa, s);
    for (int t = 1; t < num_tiles; ++t) {
      const int st = t % kStages, prev = (t - 1) % kStages;
      entry = entry_of(t);
      mbar_wait(k_full(st), (t / kStages) & 1);
      fence_regs<kOut>(o);
      wgmma_fence();
      issue_ss<T, HD, kBlockN, kHalfBytes, kHalfBytes>(s, q_addr, base + L::kK + st * L::kTileBytes);
      wgmma_commit();
      mbar_wait(v_full(prev), ((t - 1) / kStages) & 1);
      issue_rs<T, HD, kBlockN, kHalfBytes>(o, pa, base + L::kV + prev * L::kTileBytes);
      wgmma_commit();
      wgmma_wait_one();  // QK^T of tile t has landed; P V of tile t-1 may still run
      fence_regs<64>(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty(st));
      step(s, m, alpha, rowsum, t, entry);
      wgmma_wait_all();
      fence_regs<kOut>(o);
      fence_regs<kBlockN / 16>(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty(prev));
#pragma unroll
      for (int i = 0; i < kOut; ++i) o[i] *= alpha[(i >> 1) & 1];
      l[0] = l[0] * alpha[0] + rowsum[0];
      l[1] = l[1] * alpha[1] + rowsum[1];
      pack_a<T, kBlockN>(pa, s);
    }
    const int last = (num_tiles - 1) % kStages;
    mbar_wait(v_full(last), ((num_tiles - 1) / kStages) & 1);
    fence_regs<kOut>(o);
    wgmma_fence();
    issue_rs<T, HD, kBlockN, kHalfBytes>(o, pa, base + L::kV + last * L::kTileBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kOut>(o);
    fence_regs<kBlockN / 16>(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty(last));
  }

  store_out<T, HD>(p, o, m, l, q0 + cwg * 64, n, b);
}

// K7a's ring. The k and v stages lie back to back (k 0, k 1, v 0, v 1), as do
// their full and their empty barriers, so they form 2 * kStages slots. Pass A
// streams k tile i through slot i % (2 * kStages), four tiles in flight; pass B
// puts k tile t in slot t % kStages and v tile t in slot kStages + t %
// kStages, as K1 does. pass_a_loads(r, n): pass A's loads into slot r.
constexpr int kSlots = 2 * kStages;
__device__ __forceinline__ int pass_a_loads(int slot, int num_tiles) { return (num_tiles - slot + kSlots - 1) / kSlots; }
// K7a's producer: the q tile once, then pass A's k tiles and pass B's k and v
// tiles; a slot's full barrier always expects one tile's bytes. With a listed
// select, tile t is the list's entry t.
template <int HD>
__device__ __forceinline__ void produce_twopass(const CUtensorMap* q_map, const CUtensorMap* k_map,
                                                const CUtensorMap* v_map, uint32_t base, int q0, int n, int b,
                                                int num_tiles, const int* tiles = nullptr) {
  using L = Layout<HD>;
  using R = TileRow<HD>;
  const uint32_t q_full = base + L::kBars;
  mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
  for (int h = 0; h < R::kBoxes; ++h) tma_load(base + L::kQ + h * kHalfBytes, q_map, q_full, h * R::kCols, q0, n, b);
  // One tile of `map` into `slot` at its `use`-th load, once the consumers have released the slot.
  auto load = [&](const CUtensorMap* map, int slot, int use, int t) {
    const uint32_t full = q_full + 8 * (1 + slot), empty = full + 8 * kSlots;
    mbar_wait(empty, (use & 1) ^ 1);  // the first round finds every slot free
    mbar_expect_tx(full, L::kTileBytes);
#pragma unroll
    for (int h = 0; h < R::kBoxes; ++h)
      tma_load(base + L::kK + slot * L::kTileBytes + h * kHalfBytes, map, full, h * R::kCols,
               (tiles == nullptr ? t : tiles[t] & (kFullTile - 1)) * kBlockN, n, b);
  };
  for (int t = 0; t < num_tiles; ++t) load(k_map, t % kSlots, t / kSlots, t);
  for (int t = 0; t < num_tiles; ++t) {
    const int k_slot = t % kStages, v_slot = kStages + t % kStages;
    load(k_map, k_slot, pass_a_loads(k_slot, num_tiles) + t / kStages, t);
    load(v_map, v_slot, pass_a_loads(v_slot, num_tiles) + t / kStages, t);
  }
}

// Release a K7a slot: one arrival of each consumer warp on its empty barrier.
__device__ __forceinline__ void twopass_release(uint32_t empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// Pass A's step on tile t, whose scores `cur` were issued before: issue tile
// t+1's QK^T into `next` (unless t is the LAST tile), wait for `cur`, release
// its slot, and fold its row maxima into this thread's m. Only the last tile
// can hold keys at or past kv_len; they are selected out there. With a branch
// B, every tile passes B's select (pass B's, so both passes see the same keys).
template <typename T, int HD, bool LAST, int B = kNone>
__device__ __forceinline__ void twopass_max_step(float* cur, float* next, float* m, uint32_t base, uint32_t q_addr,
                                                 int t, int kv_len, int lane, const Params& p, int cwg) {
  using L = Layout<HD>;
  const uint32_t q_full = base + L::kBars;
  if constexpr (LAST) {
    wgmma_wait_all();
  } else {
    const int slot = (t + 1) % kSlots;
    mbar_wait(q_full + 8 * (1 + slot), ((t + 1) / kSlots) & 1);
    wgmma_fence();
    issue_ss<T, HD, kBlockN, kHalfBytes, kHalfBytes>(next, q_addr, base + L::kK + slot * L::kTileBytes);
    wgmma_commit();
    wgmma_wait_one();
  }
  fence_regs<64>(cur);
  twopass_release(q_full + 8 * (1 + kSlots + t % kSlots), lane);
  if constexpr (B != kNone) {
    variant_select<HD, kTwoPass, B>(p, cur, tile_entry<B>(p, t), 0, cwg, kv_len, lane);
  } else if constexpr (LAST) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (t * kBlockN + 8 * (i / 4) + 2 * (lane % 4) + (i & 1) >= kv_len) cur[i] = kNegInf;
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    m[0] = fmaxf(m[0], fmaxf(cur[4 * j], cur[4 * j + 1]));
    m[1] = fmaxf(m[1], fmaxf(cur[4 * j + 2], cur[4 * j + 3]));
  }
}

// Pass B's exponentials on a landed score tile: s overwritten by p = exp2(s -
// m) against the final max, and this tile's row sums returned. On the LAST
// tile, keys at or past kv_len are selected to -1e30 first, as K1 selects
// them, so their p is exactly 0 (m is finite: the row has a valid key).
template <bool LAST>
__device__ __forceinline__ void twopass_exp_step(float* s, const float* m, float* rowsum, int k0, int kv_len,
                                                 int lane) {
  if constexpr (LAST) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1) >= kv_len) s[i] = kNegInf;
    }
  }
  rowsum[0] = rowsum[1] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = fast_exp2(s[i] - m[(i >> 1) & 1]);
    rowsum[(i >> 1) & 1] += s[i];
  }
}

// Pass B's slots: k tile t in slot t % kStages, v tile t in slot kStages + t %
// kStages; a slot's parity counts pass A's loads into it first.
__device__ __forceinline__ int pass_b_parity(int slot, int t, int num_tiles) {
  return (pass_a_loads(slot, num_tiles) + t / kStages) & 1;
}

// Pass B's step on tile t >= 1: tile t's QK^T issued with tile t-1's P V, and
// tile t's exponentials computed while that P V runs (K1's loop without the
// rescale); LAST: t is the last tile. B: the branch, whose select tile t's
// scores pass first.
template <typename T, int HD, bool LAST, int B = kNone>
__device__ __forceinline__ void twopass_pv_step(float* s, uint32_t (*pa)[4], float* o, const float* m, float* l,
                                                uint32_t base, uint32_t q_addr, int t, int num_tiles, int kv_len,
                                                int lane, const Params& p, int cwg) {
  using L = Layout<HD>;
  constexpr int kOut = HD / 2;
  const uint32_t q_full = base + L::kBars;
  const int k_slot = t % kStages, v_slot = kStages + (t - 1) % kStages;
  float rowsum[2];
  mbar_wait(q_full + 8 * (1 + k_slot), pass_b_parity(k_slot, t, num_tiles));
  fence_regs<kOut>(o);
  wgmma_fence();
  issue_ss<T, HD, kBlockN, kHalfBytes, kHalfBytes>(s, q_addr, base + L::kK + k_slot * L::kTileBytes);
  wgmma_commit();
  mbar_wait(q_full + 8 * (1 + v_slot), pass_b_parity(v_slot, t - 1, num_tiles));
  issue_rs<T, HD, kBlockN, kHalfBytes>(o, pa, base + L::kK + v_slot * L::kTileBytes);
  wgmma_commit();
  wgmma_wait_one();  // QK^T of tile t has landed; P V of tile t-1 may still run
  fence_regs<64>(s);
  twopass_release(q_full + 8 * (1 + kSlots + k_slot), lane);
  if constexpr (B != kNone) {
    variant_select<HD, kTwoPass, B>(p, s, tile_entry<B>(p, t), 0, cwg, kv_len, lane);
    twopass_exp_step<false>(s, m, rowsum, 0, kv_len, lane);
  } else {
    twopass_exp_step<LAST>(s, m, rowsum, t * kBlockN, kv_len, lane);
  }
  wgmma_wait_all();
  fence_regs<kOut>(o);
  fence_regs<kBlockN / 16>(pa);
  twopass_release(q_full + 8 * (1 + kSlots + v_slot), lane);
  l[0] += rowsum[0];
  l[1] += rowsum[1];
  pack_a<T, kBlockN>(pa, s);
}

// A consumer warpgroup of K7a (rows and fragments as K1's consumer). B: the
// branch (segments), whose select both passes apply to each listed tile.
template <typename T, int HD, int B = kNone>
__device__ __forceinline__ void consume_twopass(const Params& p, uint32_t base, unsigned char* smem, int cwg, int q0,
                                                int n, int b, int kv_len, int num_tiles) {
  using L = Layout<HD>;
  constexpr int kOut = HD / 2;
  const int lane = threadIdx.x % 32;
  const uint32_t q_full = base + L::kBars;
  auto k_slot = [&](int t) { return t % kStages; };
  auto v_slot = [&](int t) { return kStages + t % kStages; };
  auto parity = [&](int slot, int t) { return pass_b_parity(slot, t, num_tiles); };
  auto full = [&](int slot) { return q_full + 8 * (1 + slot); };
  auto empty = [&](int slot) { return q_full + 8 * (1 + kSlots + slot); };
  auto tile = [&](int slot) { return base + L::kK + slot * L::kTileBytes; };

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const uint32_t q_addr = base + L::kQ + cwg * 64 * TileRow<HD>::kBytes;
  mbar_wait(q_full, 0);
  if (num_tiles > 0) {  // pass A: k loads 0 .. num_tiles - 1
    float sa[64], sb[64];  // two score tiles, used in turn: tile t's scores are in sa at the top of a trip
    mbar_wait(full(0), 0);
    wgmma_fence();
    issue_ss<T, HD, kBlockN, kHalfBytes, kHalfBytes>(sa, q_addr, tile(0));
    wgmma_commit();
    int t = 0;
    for (; t + 2 < num_tiles; t += 2) {
      twopass_max_step<T, HD, false, B>(sa, sb, m, base, q_addr, t, kv_len, lane, p, cwg);
      twopass_max_step<T, HD, false, B>(sb, sa, m, base, q_addr, t + 1, kv_len, lane, p, cwg);
    }
    if (t + 1 < num_tiles) {
      twopass_max_step<T, HD, false, B>(sa, sb, m, base, q_addr, t, kv_len, lane, p, cwg);
      twopass_max_step<T, HD, true, B>(sb, sa, m, base, q_addr, t + 1, kv_len, lane, p, cwg);
    } else {
      twopass_max_step<T, HD, true, B>(sa, sb, m, base, q_addr, t, kv_len, lane, p, cwg);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    }
  }

  float o[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) o[i] = 0.f;
  if (num_tiles > 0) {  // pass B
    float s[64], rowsum[2];
    uint32_t pa[kBlockN / 16][4];
    mbar_wait(full(k_slot(0)), parity(k_slot(0), 0));
    wgmma_fence();
    issue_ss<T, HD, kBlockN, kHalfBytes, kHalfBytes>(s, q_addr, tile(k_slot(0)));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<64>(s);
    twopass_release(empty(k_slot(0)), lane);
    if constexpr (B != kNone) {
      variant_select<HD, kTwoPass, B>(p, s, tile_entry<B>(p, 0), 0, cwg, kv_len, lane);
      twopass_exp_step<false>(s, m, rowsum, 0, kv_len, lane);
    } else if (num_tiles == 1) {
      twopass_exp_step<true>(s, m, rowsum, 0, kv_len, lane);
    } else {
      twopass_exp_step<false>(s, m, rowsum, 0, kv_len, lane);
    }
    l[0] = rowsum[0];
    l[1] = rowsum[1];
    pack_a<T, kBlockN>(pa, s);
    for (int t = 1; t + 1 < num_tiles; ++t)
      twopass_pv_step<T, HD, false, B>(s, pa, o, m, l, base, q_addr, t, num_tiles, kv_len, lane, p, cwg);
    if (num_tiles > 1)
      twopass_pv_step<T, HD, true, B>(s, pa, o, m, l, base, q_addr, num_tiles - 1, num_tiles, kv_len, lane, p, cwg);
    const int last = num_tiles - 1;
    mbar_wait(full(v_slot(last)), parity(v_slot(last), last));
    // The last tile's v rows past kv_len (no key tile wholly past kv_len is listed, so only the last holds them).
    const int valid_rows = kv_len - (tile_entry<B>(p, last) & (kFullTile - 1)) * kBlockN;
    if (valid_rows < kBlockN) {  // rows of v past kv_len: zeroed, so p = 0 meets 0, never a NaN
      zero_tile_rows<HD, kHalfBytes>(smem + L::kK + v_slot(last) * L::kTileBytes, valid_rows, kBlockN,
                                     threadIdx.x - 128, 128 * consumer_wgs<HD>());
      fence_proxy_async();
      named_barrier_sync(1, 128 * consumer_wgs<HD>());
    }
    fence_regs<kOut>(o);
    wgmma_fence();
    issue_rs<T, HD, kBlockN, kHalfBytes>(o, pa, tile(v_slot(last)));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kOut>(o);
    fence_regs<kBlockN / 16>(pa);
    twopass_release(empty(v_slot(last)), lane);
  }
  store_out<T, HD>(p, o, m, l, q0 + cwg * 64, n, b);
}

// K7c's step on a landed score tile: keys at or past kv_len selected out, s
// overwritten by p = exp2(s - m_cur) against the tile's own row max m_cur (the
// tile holds a valid key, so m_cur is finite and those keys' p is exactly 0),
// the running max m moved on to m_new, alpha = exp2(m - m_new) and beta =
// exp2(m_cur - m_new) returned, and this thread's partial row sums moved on to
// l*alpha + rowsum(p)*beta.
__device__ __forceinline__ void two_level_step(float* s, float* m, float* l, float* alpha, float* beta, int k0,
                                               int kv_len, int lane) {
  if (k0 + kBlockN > kv_len) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1) >= kv_len) s[i] = kNegInf;
    }
  }
  float m_cur[2] = {2.f * kNegInf, 2.f * kNegInf};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    m_cur[0] = fmaxf(m_cur[0], fmaxf(s[4 * j], s[4 * j + 1]));
    m_cur[1] = fmaxf(m_cur[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float rowsum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 1));
    m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 2));
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    s[i] = fast_exp2(s[i] - m_cur[(i >> 1) & 1]);
    rowsum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], m_cur[r]);
    alpha[r] = fast_exp2(m[r] - m_new);
    beta[r] = fast_exp2(m_cur[r] - m_new);
    m[r] = m_new;
    l[r] = l[r] * alpha[r] + rowsum[r] * beta[r];
  }
}

// acc = acc*alpha + pv*beta over N accumulator floats (a chunk of acc's
// columns and its product, in the same fragment layout).
template <int N>
__device__ __forceinline__ void two_level_fold(float* acc, const float* pv, const float* alpha, const float* beta) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = acc[i] * alpha[(i >> 1) & 1] + pv[i] * beta[(i >> 1) & 1];
}

// K7c's step on tile t, whose p is packed in pa (LAST: t is the last tile):
// tile t's P V issued into pv (overwritten by its first k-step) and, once it
// lands, folded into acc with tile t's alpha and beta; unless LAST, tile t+1's
// QK^T is issued first and tile t+1's step runs while the P V is on the tensor
// cores, then its p is packed into pa and its alpha and beta replace tile t's.
// B (the branches): tile t+1's step runs after tile t's P V has landed and
// been folded, its scores passing B's select first: the select's work beside
// the in-flight product and its registers (s, pv, pa and acc, 224 of 240)
// spilled at H=128. The select is to -inf: a row with no live key in the tile
// keeps m_cur at -2e30, so its p is exp2(-inf) = 0 and its beta exp2(-2e30 -
// m_new) = 0, never a NaN.
template <typename T, int HD, bool LAST, int B = kNone>
__device__ __forceinline__ void two_level_pv_step(float* s, float* pv, uint32_t (*pa)[4], float* o, float* m, float* l,
                                                  float* alpha, float* beta, uint32_t base, uint32_t q_addr, int t,
                                                  int kv_len, int lane, const Params& p, int cwg) {
  using L = Layout<HD, consumer_wgs<HD, kTwoLevel>()>;
  const uint32_t q_full = base + L::kBars;
  const int st = t % kStages, next = (t + 1) % kStages;
  const uint32_t k_full = q_full + 8 * (1 + next), v_full = q_full + 8 * (1 + kStages + st);
  const uint32_t k_empty = q_full + 8 * (1 + 2 * kStages + next), v_empty = q_full + 8 * (1 + 3 * kStages + st);
  const uint32_t k_tile = base + L::kK + next * L::kTileBytes, v_tile = base + L::kV + st * L::kTileBytes;
  if constexpr (!LAST) mbar_wait(k_full, ((t + 1) / kStages) & 1);
  wgmma_fence();
  if constexpr (!LAST) {
    issue_ss<T, HD, kBlockN, kHalfBytes, kHalfBytes>(s, q_addr, k_tile);
    wgmma_commit();
  }
  mbar_wait(v_full, (t / kStages) & 1);
  issue_rs<T, HD, kBlockN, kHalfBytes>(pv, pa, v_tile, true);
  wgmma_commit();
  float alpha_next[2], beta_next[2];
  if constexpr (!LAST && B == kNone) {
    wgmma_wait_one();  // QK^T of tile t+1 has landed; tile t's P V may still run
    fence_regs<64>(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty);
    two_level_step(s, m, l, alpha_next, beta_next, (t + 1) * kBlockN, kv_len, lane);
  }
  wgmma_wait_all();
  if constexpr (!LAST && B != kNone) fence_regs<64>(s);
  fence_regs<HD / 2>(pv);
  fence_regs<kBlockN / 16>(pa);
  __syncwarp();
  if (lane == 0) {
    mbar_arrive(v_empty);
    if (!LAST && B != kNone) mbar_arrive(k_empty);
  }
  two_level_fold<HD / 2>(o, pv, alpha, beta);
  if constexpr (!LAST && B != kNone) {
    variant_select<HD, kTwoLevel, B>(p, s, tile_entry<B>(p, t + 1), 0, cwg, kv_len, lane);
    two_level_step(s, m, l, alpha_next, beta_next, 0, 0x7fffffff, lane);
  }
  if constexpr (!LAST) {
    pack_a<T, kBlockN>(pa, s);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = alpha_next[r];
      beta[r] = beta_next[r];
    }
  }
}

// A consumer warpgroup of K7c (rows and fragments as K1's consumer): tile 0's
// QK^T and step, then two_level_pv_step on each tile. Tile t's p v is a product
// of its own (pv, overwritten by its first k-step), so it never accumulates
// into acc. B: the branch, whose tiles and select are K1's.
template <typename T, int HD, int B = kNone>
__device__ __forceinline__ void consume_two_level(const Params& p, uint32_t base, int cwg, int q0, int n, int b,
                                                  int kv_len, int num_tiles) {
  using L = Layout<HD, consumer_wgs<HD, kTwoLevel>()>;
  constexpr int kOut = HD / 2;
  const int lane = threadIdx.x % 32;
  const uint32_t q_full = base + L::kBars;

  float o[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums; reduced over the quad at the end

  const uint32_t q_addr = base + L::kQ + cwg * 64 * TileRow<HD>::kBytes;
  mbar_wait(q_full, 0);
  if (num_tiles > 0) {
    float s[64], pv[kOut], alpha[2], beta[2];
    uint32_t pa[kBlockN / 16][4];
    mbar_wait(q_full + 8, 0);  // k_full of stage 0
    wgmma_fence();
    issue_ss<T, HD, kBlockN, kHalfBytes, kHalfBytes>(s, q_addr, base + L::kK);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<64>(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(q_full + 8 * (1 + 2 * kStages));  // k_empty of stage 0
    if constexpr (B != kNone) {
      variant_select<HD, kTwoLevel, B>(p, s, tile_entry<B>(p, 0), 0, cwg, kv_len, lane);
      two_level_step(s, m, l, alpha, beta, 0, 0x7fffffff, lane);
    } else {
      two_level_step(s, m, l, alpha, beta, 0, kv_len, lane);
    }
    pack_a<T, kBlockN>(pa, s);
#pragma unroll
    for (int i = 0; i < kOut; ++i) pv[i] = 0.f;  // overwritten by each product's first k-step
    for (int t = 0; t + 1 < num_tiles; ++t)
      two_level_pv_step<T, HD, false, B>(s, pv, pa, o, m, l, alpha, beta, base, q_addr, t, kv_len, lane, p, cwg);
    two_level_pv_step<T, HD, true, B>(s, pv, pa, o, m, l, alpha, beta, base, q_addr, num_tiles - 1, kv_len, lane, p,
                                      cwg);
  }
  store_out<T, HD>(p, o, m, l, q0 + cwg * 64, n, b);
}

// K7b's score tile: 64 keys, half a ring stage (m64n64 scores, 32 floats a
// thread), at both head dims (see the note at the top).
constexpr int kSkewKeys = 64;

// Scale this consumer warpgroup's 64 rows of the q tile (`q_tile`, a generic
// pointer to shared memory) by `mul` and round them to T, in place, as
// `rope_scale_8` rounds the pre-pass's q_s; the swizzle permutes 16-byte
// chunks inside a row, which an elementwise scale does not see.
template <typename T, int HD>
__device__ __forceinline__ void scale_q_rows(unsigned char* q_tile, int cwg, float mul) {
  using R = TileRow<HD>;
  constexpr int kPerRow = R::kBytes / 16;  // 16-byte chunks of a box row
  for (int i = threadIdx.x % 128; i < R::kBoxes * 64 * kPerRow; i += 128) {  // (box, row, chunk)
    const int box = i / (64 * kPerRow), row = i / kPerRow % 64, chunk = i % kPerRow;
    uint4* at = reinterpret_cast<uint4*>(q_tile + box * kHalfBytes + (64 * cwg + row) * R::kBytes + chunk * 16);
    *at = rope_scale_8<T>(*at, nullptr, nullptr, mul);
  }
}

// K7b's ring, in score tiles of kSkewKeys keys: tile w lies in stage (w /
// kPer) % kStages at row (w % kPer) * kSkewKeys (rows of TileRow<HD>::kBytes);
// a stage is released after its last tile.
template <int HD>
struct SkewRing {
  static constexpr int kPer = kBlockN / kSkewKeys;  // score tiles per stage
  uint32_t base, q_full;
  int num_sub;
  __device__ __forceinline__ int stage(int w) const { return w / kPer % kStages; }
  __device__ __forceinline__ uint32_t parity(int w) const { return (w / kPer / kStages) & 1; }
  __device__ __forceinline__ uint32_t row(int w) const { return w % kPer * kSkewKeys * TileRow<HD>::kBytes; }
  __device__ __forceinline__ bool last_in_stage(int w) const { return w % kPer == kPer - 1 || w == num_sub - 1; }
  __device__ __forceinline__ uint32_t k_full(int w) const { return q_full + 8 * (1 + stage(w)); }
  __device__ __forceinline__ uint32_t v_full(int w) const { return q_full + 8 * (1 + kStages + stage(w)); }
  __device__ __forceinline__ uint32_t k_empty(int w) const { return q_full + 8 * (1 + 2 * kStages + stage(w)); }
  __device__ __forceinline__ uint32_t v_empty(int w) const { return q_full + 8 * (1 + 3 * kStages + stage(w)); }
};

// K7b's step u >= 1, with tile u-1's scores landed in `prev`: tile u's QK^T
// is issued into `cur` (unless LAST: u-1 is the last tile), K1's softmax step
// runs on `prev` while it is on the tensor cores, acc is rescaled, p packed and
// tile u-1's P V issued; then both are waited for and their stages released.
// B: the branch (segments), whose select `prev` passes first: score tile w is
// the (w % 2)-th 64-key half of the list's entry w / 2.
template <typename T, int HD, bool LAST, int B = kNone>
__device__ __forceinline__ void skew_step(float* cur, float* prev, uint32_t (*pa)[4], float* o, float* m, float* l,
                                          const SkewRing<HD>& ring, uint32_t q_addr, int u, int kv_len, int lane,
                                          const Params& p, int cwg) {
  using L = Layout<HD, consumer_wgs<HD, kSkew>()>;
  constexpr int kSub = kSkewKeys;
  const int w = u - 1;
  if constexpr (!LAST) {
    mbar_wait(ring.k_full(u), ring.parity(u));
    wgmma_fence();
    issue_ss<T, HD, kSub, kHalfBytes, kHalfBytes, true>(
        cur, q_addr, ring.base + L::kK + ring.stage(u) * L::kTileBytes + ring.row(u));
    wgmma_commit();
  }
  float alpha[2], rowsum[2];
  if constexpr (B != kNone) {
    variant_select<HD, kSkew, B, kSub>(p, prev, tile_entry<B>(p, w / SkewRing<HD>::kPer),
                                       w % SkewRing<HD>::kPer * kSub, cwg, kv_len, lane);
    softmax_step<kSub>(prev, m, alpha, rowsum, 0, 0x7fffffff, lane);
  } else {
    softmax_step<kSub>(prev, m, alpha, rowsum, w * kSub, kv_len, lane);
  }
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
  l[0] = l[0] * alpha[0] + rowsum[0];
  l[1] = l[1] * alpha[1] + rowsum[1];
  pack_a<T, kSub>(pa, prev);
  mbar_wait(ring.v_full(w), ring.parity(w));
  wgmma_fence();
  issue_rs<T, HD, kSub, kHalfBytes>(o, pa, ring.base + L::kV + ring.stage(w) * L::kTileBytes + ring.row(w));
  wgmma_commit();
  wgmma_wait_all();  // tile u's scores and tile u-1's P V have landed
  if constexpr (!LAST) fence_regs<kSub / 2>(cur);
  fence_regs<HD / 2>(o);
  fence_regs<kSub / 16>(pa);
  __syncwarp();
  if (lane == 0) {
    if (!LAST && ring.last_in_stage(u)) mbar_arrive(ring.k_empty(u));
    if (ring.last_in_stage(w)) mbar_arrive(ring.v_empty(w));
  }
}

// A consumer warpgroup of K7b (rows and fragments as K1's consumer): q scaled
// in place, then tile 0's QK^T, then the skewed steps over two score arrays
// used in turn (tile u-1's scores are in `sa` at the top of a trip). The
// TPU kernel's first step, on a dummy tile of 2*(-1e30), is an identity (p =
// 0, alpha = 1) and is left out. B: the branch (segments), whose num_tiles
// listed key tiles give two score tiles each.
template <typename T, int HD, int B = kNone>
__device__ __forceinline__ void consume_skew(const Params& p, uint32_t base, unsigned char* smem, int cwg, int q0,
                                             int n, int b, int kv_len, int num_tiles) {
  using L = Layout<HD, consumer_wgs<HD, kSkew>()>;
  constexpr int kSub = kSkewKeys;
  const int lane = threadIdx.x % 32;
  const SkewRing<HD> ring{base, base + L::kBars,
                          B == kNone ? (kv_len + kSub - 1) / kSub : SkewRing<HD>::kPer * num_tiles};

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const uint32_t q_addr = base + L::kQ + cwg * 64 * TileRow<HD>::kBytes;
  mbar_wait(ring.q_full, 0);
  scale_q_rows<T, HD>(smem + L::kQ, cwg, p.q_scale);
  fence_proxy_async();  // the scaled rows, visible to wgmma
  named_barrier_sync(1 + cwg, 128);
  const int num_sub = ring.num_sub;
  if (num_sub > 0) {
    float sa[kSub / 2], sb[kSub / 2];
    uint32_t pa[kSub / 16][4];
    mbar_wait(ring.k_full(0), 0);
    wgmma_fence();
    issue_ss<T, HD, kSub, kHalfBytes, kHalfBytes, true>(sa, q_addr, base + L::kK);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kSub / 2>(sa);
    __syncwarp();
    if (lane == 0 && ring.last_in_stage(0)) mbar_arrive(ring.k_empty(0));
    int u = 1;
    for (; u + 1 < num_sub; u += 2) {
      skew_step<T, HD, false, B>(sb, sa, pa, o, m, l, ring, q_addr, u, kv_len, lane, p, cwg);
      skew_step<T, HD, false, B>(sa, sb, pa, o, m, l, ring, q_addr, u + 1, kv_len, lane, p, cwg);
    }
    if (u < num_sub) {
      skew_step<T, HD, false, B>(sb, sa, pa, o, m, l, ring, q_addr, u, kv_len, lane, p, cwg);
      skew_step<T, HD, true, B>(sa, sb, pa, o, m, l, ring, q_addr, u + 1, kv_len, lane, p, cwg);
    } else {
      skew_step<T, HD, true, B>(sb, sa, pa, o, m, l, ring, q_addr, u, kv_len, lane, p, cwg);
    }
  }
  store_out<T, HD>(p, o, m, l, q0 + cwg * 64, n, b);
}

// K1, K7a, K7c or K7b (step S) or one of their branches (select B): one CTA
// per (q tile of block_m rows, head, batch).
template <typename T, int HD, int S, int B>
__device__ __forceinline__ void fwd_cta(const CUtensorMap* q_map, const CUtensorMap* k_map, const CUtensorMap* v_map,
                                        const Params& p, unsigned char* smem_raw) {
  constexpr int kWgs = consumer_wgs<HD, S>();
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + Layout<HD, kWgs>::kBars;
  const CtaAt at = cta_at<B>();
  const int q_tile = at.q_tile, n = at.n, b = at.b;
  const int q0 = q_tile * block_m<HD, S>();
  int kv_len = p.seq_kv;
  if (p.kv_lens != nullptr) kv_len = min(max(p.kv_lens[b], 0), p.seq_kv);
  int num_tiles = (kv_len + kBlockN - 1) / kBlockN;
  const int* tiles = nullptr;
  if constexpr (listed(B)) {  // the live key tiles of this (b, q tile)
    const int cell = b * p.q_tiles + q_tile;
    num_tiles = p.tile_counts[cell];
    tiles = p.tiles + (int64_t)cell * p.kv_tiles;
    if (B == kMasked) kv_len = 0x7fffffff;  // the mask alone selects keys
  }
  if constexpr (B == kCausal) {  // up to the key tile of the last row's diagonal
    const int last = min(q0 + block_m<HD, S>(), p.seq_q) - 1 + p.seq_kv - p.seq_q;
    num_tiles = last < 0 ? 0 : min(num_tiles, last / kBlockN + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(q_full + 8 * (1 + st), 1);                          // k_full
      mbar_init(q_full + 8 * (1 + kStages + st), 1);                // v_full
      mbar_init(q_full + 8 * (1 + 2 * kStages + st), 4 * kWgs);  // k_empty: one arrival a warp
      mbar_init(q_full + 8 * (1 + 3 * kStages + st), 4 * kWgs);  // v_empty
    }
    mbar_init_fence();
  }
  __syncthreads();

  // One if/else for the whole lifetime of each role, so setmaxnreg applies.
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      if constexpr (S == kTwoPass) {
        produce_twopass<HD>(q_map, k_map, v_map, base, q0, n, b, num_tiles, tiles);
      } else {
        produce<HD, kWgs>(q_map, k_map, v_map, base, q0, n, b, num_tiles, tiles);
      }
    }
  } else {
    setmaxnreg_inc<consumer_regs<HD, S>()>();
    const int cwg = threadIdx.x / 128 - 1;
    unsigned char* smem = smem_raw + (base - smem_addr(smem_raw));
    if constexpr (S == kTwoPass) {
      consume_twopass<T, HD, B>(p, base, smem, cwg, q0, n, b, kv_len, num_tiles);
    } else if constexpr (S == kTwoLevel) {
      consume_two_level<T, HD, B>(p, base, cwg, q0, n, b, kv_len, num_tiles);
    } else if constexpr (S == kSkew) {
      consume_skew<T, HD, B>(p, base, smem, cwg, q0, n, b, kv_len, num_tiles);
    } else {
      consume<T, HD, B>(p, base, cwg, q0, n, b, kv_len, num_tiles, tiles);
    }
  }
}

#define FWD_KERNEL(NAME, S, B)                                                                                 \
  template <typename T, int HD>                                                                                \
  __global__ void __launch_bounds__(threads<HD, S>(), 1)                                                       \
      NAME(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,               \
           const __grid_constant__ CUtensorMap v_map, const Params p) {                                        \
    extern __shared__ unsigned char smem_raw[];                                                                \
    fwd_cta<T, HD, S, B>(&q_map, &k_map, &v_map, p, smem_raw);                                                 \
  }
FWD_KERNEL(flash_fwd_sm90_kernel, kStraight, kNone)
FWD_KERNEL(flash_fwd_twopass_sm90_kernel, kTwoPass, kNone)
FWD_KERNEL(flash_fwd_two_level_sm90_kernel, kTwoLevel, kNone)
FWD_KERNEL(flash_fwd_skew_sm90_kernel, kSkew, kNone)
FWD_KERNEL(flash_fwd_mask_sm90_kernel, kStraight, kMasked)
FWD_KERNEL(flash_fwd_causal_sm90_kernel, kStraight, kCausal)
FWD_KERNEL(flash_fwd_segment_sm90_kernel, kStraight, kSegment)
FWD_KERNEL(flash_fwd_two_level_causal_sm90_kernel, kTwoLevel, kCausal)
FWD_KERNEL(flash_fwd_two_level_segment_sm90_kernel, kTwoLevel, kSegment)
FWD_KERNEL(flash_fwd_two_level_mask_sm90_kernel, kTwoLevel, kMasked)
FWD_KERNEL(flash_fwd_twopass_segment_sm90_kernel, kTwoPass, kSegment)
FWD_KERNEL(flash_fwd_skew_segment_sm90_kernel, kSkew, kSegment)
#undef FWD_KERNEL

// The (S, B) kernel at (T, HD); only the pairs a library's entry points launch
// are instantiated, so each library compiles its own kernels.
template <typename T, int HD, int S, int B>
constexpr auto kernel_of() {
  if constexpr (S == kStraight && B == kNone) return flash_fwd_sm90_kernel<T, HD>;
  else if constexpr (S == kTwoPass && B == kNone) return flash_fwd_twopass_sm90_kernel<T, HD>;
  else if constexpr (S == kTwoLevel && B == kNone) return flash_fwd_two_level_sm90_kernel<T, HD>;
  else if constexpr (S == kSkew && B == kNone) return flash_fwd_skew_sm90_kernel<T, HD>;
  else if constexpr (S == kStraight && B == kMasked) return flash_fwd_mask_sm90_kernel<T, HD>;
  else if constexpr (S == kStraight && B == kCausal) return flash_fwd_causal_sm90_kernel<T, HD>;
  else if constexpr (S == kStraight && B == kSegment) return flash_fwd_segment_sm90_kernel<T, HD>;
  else if constexpr (S == kTwoLevel && B == kCausal) return flash_fwd_two_level_causal_sm90_kernel<T, HD>;
  else if constexpr (S == kTwoLevel && B == kSegment) return flash_fwd_two_level_segment_sm90_kernel<T, HD>;
  else if constexpr (S == kTwoLevel && B == kMasked) return flash_fwd_two_level_mask_sm90_kernel<T, HD>;
  else if constexpr (S == kTwoPass && B == kSegment) return flash_fwd_twopass_segment_sm90_kernel<T, HD>;
  else return flash_fwd_skew_segment_sm90_kernel<T, HD>;
}

template <typename T, int HD, int S, int B>
cudaError_t launch(const CUtensorMap& q_map, const CUtensorMap& k_map, const CUtensorMap& v_map, const Params& p,
                   int batch, cudaStream_t stream) {
  auto kernel = kernel_of<T, HD, S, B>();
  const dim3 grid((p.seq_q + block_m<HD, S>() - 1) / block_m<HD, S>(), p.heads, batch);
  static std::atomic<uint64_t> attribute_set{0};
  // + 1024 bytes of slack to align the base to 1024 bytes
  return launch_sm90(kernel, attribute_set, grid, threads<HD, S>(), Layout<HD, consumer_wgs<HD, S>()>::kBytes + 1024,
                     stream, q_map, k_map, v_map, p);
}

template <int S, int B>
int fwd_entry(const void* q_s, const void* k_r, const void* v, void* out, void* lse, const void* kv_lens, int batch,
              int heads, int seq_q, int seq_kv, int head_dim, int dtype, const int64_t* strides, float q_scale,
              void* stream, const void* mask = nullptr, const void* tiles = nullptr, const void* tile_counts = nullptr,
              int q_tiles = 0, int kv_tiles = 0, const void* q_seg = nullptr, const void* kv_seg = nullptr,
              int64_t q_seg_len = 0, int64_t kv_seg_len = 0) {
  if (!takes(dtype, head_dim)) return cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  const int q_rows = head_dim == 32 ? block_m<32, S>() : head_dim == 64 ? block_m<64, S>() : block_m<128, S>();
  if (!encode_operand(&q_map, q_s, dtype, head_dim, seq_q, heads, batch, q_rows, strides[0], strides[1], strides[2]) ||
      !encode_operand(&k_map, k_r, dtype, head_dim, seq_kv, heads, batch, kBlockN, strides[3], strides[4],
                      strides[5]) ||
      !encode_operand(&v_map, v, dtype, head_dim, seq_kv, heads, batch, kBlockN, strides[6], strides[7], strides[8]))
    return cudaErrorInvalidValue;
  Params p;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.heads = heads;
  p.seq_q = seq_q;
  p.seq_kv = seq_kv;
  p.o_sb = strides[9]; p.o_sn = strides[10]; p.o_ss = strides[11];
  p.q_scale = q_scale;
  p.mask = static_cast<const unsigned char*>(mask);
  p.tiles = static_cast<const int*>(tiles);
  p.tile_counts = static_cast<const int*>(tile_counts);
  p.q_tiles = q_tiles;
  p.kv_tiles = kv_tiles;
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.q_seg_len = q_seg_len;
  p.kv_seg_len = kv_seg_len;
  if (listed(B) && (tiles == nullptr || tile_counts == nullptr || q_tiles != (seq_q + q_rows - 1) / q_rows ||
                    kv_tiles != (seq_kv + kBlockN - 1) / kBlockN))
    return cudaErrorInvalidValue;
  if (B == kMasked && (mask == nullptr || kv_lens != nullptr)) return cudaErrorInvalidValue;
  // The ids are read in whole tiles: q rows up to q_tiles * q_rows, keys up to kv_tiles * 128.
  if (B == kSegment && (q_seg == nullptr || kv_seg == nullptr || q_seg_len < (int64_t)q_tiles * q_rows ||
                        kv_seg_len < (int64_t)kv_tiles * kBlockN))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_type(dtype, head_dim, [&](auto type, auto hd) {
    return launch<typename decltype(type)::type, decltype(hd)::value, S, B>(q_map, k_map, v_map, p, batch, s);
  });
}

}  // namespace

#if defined(FLASH_FWD_BRANCHES)
// K1's branches (built from flash_fwd_branches_sm90.cu, which defines
// FLASH_FWD_BRANCHES), arguments as K1's below. The causal branch: K1's.
extern "C" int flash_fwd_causal_sm90(const void* q_s, const void* k_r, const void* v, void* out, void* lse,
                                     const void* kv_lens, int batch, int heads, int seq_q, int seq_kv, int head_dim,
                                     int dtype, const int64_t* strides, void* stream) {
  return fwd_entry<kStraight, kCausal>(q_s, k_r, v, out, lse, kv_lens, batch, heads, seq_q, seq_kv, head_dim, dtype,
                                       strides, 1.f, stream);
}

// The segment branch: K1's arguments, then the padded q and key ids (int32,
// q_seg_len and kv_seg_len per batch, at least the q tiles' rows and the key
// tiles' columns), the live-tile lists and counts (as the mask branch's), and
// the q and key tile counts.
extern "C" int flash_fwd_segment_sm90(const void* q_s, const void* k_r, const void* v, void* out, void* lse,
                                      const void* kv_lens, const void* q_seg, const void* kv_seg, const void* tiles,
                                      const void* tile_counts, int64_t q_seg_len, int64_t kv_seg_len, int batch,
                                      int heads, int seq_q, int seq_kv, int head_dim, int dtype,
                                      const int64_t* strides, int q_tiles, int kv_tiles, void* stream) {
  return fwd_entry<kStraight, kSegment>(q_s, k_r, v, out, lse, kv_lens, batch, heads, seq_q, seq_kv, head_dim, dtype,
                                        strides, 1.f, stream, nullptr, tiles, tile_counts, q_tiles, kv_tiles, q_seg,
                                        kv_seg, q_seg_len, kv_seg_len);
}

// The mask branch: K1's arguments without kv_lens, then the padded mask, the
// live-tile lists and counts, and the q and key tile counts (see Params; the
// q tile is 128 rows at head dim 128, 192 at 64 and 32).
extern "C" int flash_fwd_mask_sm90(const void* q_s, const void* k_r, const void* v, void* out, void* lse,
                                   const void* mask, const void* tiles, const void* tile_counts, int batch, int heads,
                                   int seq_q, int seq_kv, int head_dim, int dtype, const int64_t* strides, int q_tiles,
                                   int kv_tiles, void* stream) {
  return fwd_entry<kStraight, kMasked>(q_s, k_r, v, out, lse, nullptr, batch, heads, seq_q, seq_kv, head_dim, dtype,
                                       strides, 1.f, stream, mask, tiles, tile_counts, q_tiles, kv_tiles);
}
#elif defined(FLASH_FWD_VARIANT_BRANCHES)
// The branches of K7a, K7b and K7c (built from
// flash_fwd_variant_branches_sm90.cu, which defines FLASH_FWD_VARIANT_BRANCHES),
// one entry for all: `step` 1 K7a, 2 K7c, 3 K7b; `branch` 1 causal, 2 segment
// ids, 3 a dense mask (kv_lens folded in, so null); K7c takes all three, K7a
// and K7b segments only. Then K1's arguments, the padded mask (or null), the
// padded q and key ids with their per-batch lengths (or null), the live-tile
// lists and counts (segments and masks), the q and key tile counts, and K7b's
// q_scale (scale * log2(e); the others take the pre-pass's q_s). K7c's q tile
// is 128 rows at both head dims, K7a's K1's.
extern "C" int flash_fwd_variant_branch_sm90(int step, int branch, const void* q_s, const void* k_r, const void* v,
                                             void* out, void* lse, const void* kv_lens, const void* mask,
                                             const void* q_seg, const void* kv_seg, int64_t q_seg_len,
                                             int64_t kv_seg_len, const void* tiles, const void* tile_counts, int batch,
                                             int heads, int seq_q, int seq_kv, int head_dim, int dtype,
                                             const int64_t* strides, int q_tiles, int kv_tiles, float q_scale,
                                             void* stream) {
#define VARIANT_BRANCH(S, B)                                                                                     \
  fwd_entry<S, B>(q_s, k_r, v, out, lse, kv_lens, batch, heads, seq_q, seq_kv, head_dim, dtype, strides, q_scale, \
                  stream, mask, tiles, tile_counts, q_tiles, kv_tiles, q_seg, kv_seg, q_seg_len, kv_seg_len)
  if (step == kTwoLevel && branch == kCausal) return VARIANT_BRANCH(kTwoLevel, kCausal);
  if (step == kTwoLevel && branch == kSegment) return VARIANT_BRANCH(kTwoLevel, kSegment);
  if (step == kTwoLevel && branch == kMasked) return VARIANT_BRANCH(kTwoLevel, kMasked);
  if (step == kTwoPass && branch == kSegment) return VARIANT_BRANCH(kTwoPass, kSegment);
  if (step == kSkew && branch == kSegment) return VARIANT_BRANCH(kSkew, kSegment);
#undef VARIANT_BRANCH
  return cudaErrorInvalidValue;
}
#else
// Plain C entry points, loaded with ctypes: K1, K7a, K7c and K7b. q_s and k_r
// are the pre-pass's operands (k itself when there are no RoPE tables); K7b
// takes the raw q and k and scales q by `q_scale` (scale * log2(e)) itself.
// dtype: 0 = bf16, 1 = fp16; strides: q_s, k_r, v, out, each (batch, head,
// seq), in elements; the head dim is contiguous and every operand 16-byte
// aligned; head_dim 32, 64 or 128. Each returns a cudaError_t
// (cudaErrorInvalidValue also when a tensor map cannot be encoded).
#define FWD_ENTRY(NAME, S)                                                                                      \
  extern "C" int NAME(const void* q_s, const void* k_r, const void* v, void* out, void* lse, const void* kv_lens, \
                      int batch, int heads, int seq_q, int seq_kv, int head_dim, int dtype, const int64_t* strides, \
                      void* stream) {                                                                           \
    return fwd_entry<S, kNone>(q_s, k_r, v, out, lse, kv_lens, batch, heads, seq_q, seq_kv, head_dim, dtype,    \
                               strides, 1.f, stream);                                                           \
  }
FWD_ENTRY(flash_fwd_sm90, kStraight)
FWD_ENTRY(flash_fwd_twopass_sm90, kTwoPass)
FWD_ENTRY(flash_fwd_two_level_sm90, kTwoLevel)
#undef FWD_ENTRY

extern "C" int flash_fwd_skew_sm90(const void* q, const void* k, const void* v, void* out, void* lse,
                                   const void* kv_lens, int batch, int heads, int seq_q, int seq_kv, int head_dim,
                                   int dtype, const int64_t* strides, float q_scale, void* stream) {
  return fwd_entry<kSkew, kNone>(q, k, v, out, lse, kv_lens, batch, heads, seq_q, seq_kv, head_dim, dtype, strides,
                                 q_scale, stream);
}
#endif
