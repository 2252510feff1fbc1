// Batched pattern (NFA) block step with fused egress compaction, for
// NVIDIA Hopper (sm_90a).
//
// Replaces siddhi_tpu/ops/nfa.py:579 _one_partition_step as the JAX package
// runs it under :1110 build_block_step (lax.scan over the block's T events
// inside vmap over P partition lanes), followed by the match compaction
// siddhi_tpu/plan/nfa_compiler.py:1837 pack (jnp.nonzero(size=cap) and
// gathers).  Contract (siddhi_tpu_torch/ops/nfa.py, nfa_block_step_plain
// then egress_pack_plain): per lane p, for each event t in order, within
// expiry of live partials, one transition per slot waiting at a unit whose
// condition holds (capture row written, advance or complete; a kleene count
// appends; an absent unit's arrival kills), the live append of forwarded
// counts, then arming of a fresh partial at unit 0 in the first free slot,
// then the absent deadline pass; a NEW carry (the input carry is only
// read: grow-and-replay re-runs a chunk from it) and the egress slab
// [cap + 1, 4 + R*C] int32 of the matched slots in ascending flat index
// (p*T + t)*K + k: index, ts, enter, seq, capture row bitcast; rows past the
// count hold -1 in column 0; the tail row holds the true count, the summed
// `dropped` and, with absent units, the earliest deadline of the slots
// waiting at one (2^31 - 1: none).  One status row follows the tail:
// the fullest scratch segment's row count and the segment size (the
// caller re-runs the step with larger segments when the first exceeds the
// second).  The dense [P, T, K, ...] outputs never reach device memory.
//
// The step's class (ops/nfa.kernel_class_reason and the compiler's
// condition split) is the JAX step's structural class: simple units,
// logical `and` / `or` units, kleene counts <m:n> (a leading min-0 one
// too; min == max and an unbounded max included) and absent units `not X
// for t` (a leading one too); PATTERN and SEQUENCE; `every` on the
// leading unit, over a group, mid-chain (at most kMaxMid groups) or
// trailing, or none; optional `within`; the telemetry leaf.  Condition i
// is bit i of a block-wide gate word (its capture-free part, computed by
// the torch condition program) AND a table of `event lane <op> capture
// lane` compares AND one of `capture lane <op> constant` compares (a
// capture lane: another unit's first bank, or an earlier count's [last]
// bank) AND its program (plan/nfa_program.py: the conjuncts no table
// takes and the plain condition's guards, a postfix program over event
// lanes, the slot's capture lanes, pattern constants and constants that
// nfa_step.cuh's eval_prog runs on a float32 register stack, each
// arithmetic op one IEEE operation rounded to nearest); bit 31 of the
// word is the event's __valid.  A spec with a program launches from the
// build variant with -DNFA_PROG=1 (ops/_kernels.VARIANTS: nfa_prog, and
// nfa_wide_prog, nfa_gang_prog); the default build's instances compile
// the program's code away, so a spec without one keeps their registers.
// The pattern bank takes the same class (ops/nfa.bank_class_reason):
// a widened program runs the bank's widened instance, csrc/nfa_wide.cu's
// nfa_bank_step_wide.  A count's capture row
// holds its first bank, its last bank, its e[k] banks, its e[last-j] banks
// and its __n lane; the program gives each count row's layout.
//
// Arithmetic is exact: the float work is the IEEE compares of the tables
// (a NaN operand makes < <= > >= == false and != true, as torch's), the
// programs' IEEE operations (as the torch program computes them, one for
// one), copies and a count's __n lane (an int converted to float, as
// torch converts it); int32 timestamp offsets add and subtract with
// two's-complement wrap, and `deadline <= ts` is a signed compare.
//
// What bounds it on this card.  The function reads the block's inputs
// once, P*T*(4*n_lanes + 4 ts + 4 stream + 1 valid + n_gates) bytes, reads
// and writes the carry once (P*K*(16 + 4*R*C) + P*12 each way; 8 more
// bytes a slot with count units, 4 with absent units), and writes the
// slab, (4 + R*C)*4 bytes per matched slot.  At the main path's shape
// (P = 16384, T ~ 50, K = 8, R*C = 2, ~7,600 matches) that is ~19 MB
// against ~10^8 integer compares and selects: bound by bytes, ~6 us on
// HBM3 (chip_smoke.py computes it per launch).
//
// The design.
//  - nfa_step: a group of G threads per lane, G = K rounded up to a power
//    of two, at most 32, so at K = 8 four lanes share a warp and every
//    thread works; thread `gl` of a group owns slots gl, gl + G, ...
//    Instances for 1, 2 and 4 slots per thread keep state, start, enter
//    and seq in registers and the capture rows in thread-private shared
//    memory for the whole T loop (read once from the carry, written once
//    at the end).  A wider ring (K > 128) runs the "wide-ring" instance:
//    32 threads per lane working in place in the new carry (device memory,
//    L1-resident), which takes any K.
//  - The CTA's lanes are adjacent rows of the [P, T] inputs: T-tiles of
//    ts, stream, gate word and the kernel's attribute lanes are staged in
//    shared memory with cp.async, double-buffered, each tile a run of
//    coalesced loads per lane row; any T (T = 1 for TIMER and warm blocks,
//    thousands for a skewed key).
//  - Arming takes the first free slot of the lane: __ffs over the group's
//    bits of __ballot_sync, free meaning empty and not completed by this
//    event (from registers).  A completing slot's rank in its lane is the
//    lane's running count plus __popc(ballot & group & lanemask_lt), which
//    keeps (t, k) order; its row goes to the CTA's segment of a scratch
//    buffer at a place taken from a shared-memory counter, tagged with its
//    flat index, lane and rank.  Each lane's count goes to a [P] array and
//    the CTA's true fill (which may exceed the segment) to a [n_cta] array.
//  - An event takes two passes over a lane's slots (see step_body): the
//    transitions first, against the captures as they stand before the
//    event; then, once the first free slot is known, arming, the deadline
//    pass and the rows, in slot order.  A slot's count words (cnt_cur,
//    cnt_prev) and deadline live where its state lives.
//  - The widened instance (WIDE, flag kFlagWide: every spec beyond the
//    simple, count and absent units of PATTERN with a leading `every`)
//    runs ops/nfa.py _one_event_step section by section on the lane's G
//    threads (nfa_step.cuh Wide::event): within expiry, the leading
//    absent and min-0 ensure-arm steps, SEQUENCE's early deadline pass
//    and barrier, the unit loop in unit order (a landing ranks its slots
//    by (enter, seq) against the others landing from that unit: a
//    shuffle sweep), live appends, strict contiguity, arming, the
//    every-min-0 seed, the mid-chain clones (a prefix popcount of the
//    free slots matched to the sources' ranks; captures copied between
//    threads through shared memory or the carry after __syncwarp), the
//    deadline pass.  Every lane-wide step is a ballot over the group's
//    bits taken by the whole warp.  A completing slot writes its row at
//    once (a trailing `every` clears rows right after) and its rank when
//    the event ends.  Telemetry counts in shared memory a lane row.
//  - Flag kFlagPadWithin: one more `within` pass at the last event's ts
//    after the block, as the plain step's padding rows (a block padded
//    to a multiple of its B) do.
//  - nfa_compact: one CTA per step CTA; it sums the fills of the CTAs
//    before it, scans its lanes' counts, scatters each scratch row to
//    slab[offset(p) + rank] when that is below cap, writes -1 into column
//    0 of the rows past the count, and CTA 0 writes the tail (count,
//    summed dropped, the least of the step's per-CTA earliest deadlines)
//    and the status row.  A cap overflow re-runs this kernel alone, from
//    the same scratch, and gives the same tail.
//
// The pattern bank (siddhi_tpu/ops/nfa.py:1167 build_bank_step and :1266
// build_super_bank_step: the step above vmapped over C*N patterns that
// differ only in their constants, per-pattern match counts, and a top-ring
// payload ring).  Contract: siddhi_tpu_torch/ops/nfa.py bank_lanes_plain
// then bank_ring_plain.  A condition is its gate bit (the capture-free,
// constant-free part, shared by every pattern) AND its `event lane <op>
// pattern constant` compares AND its capture compares AND its program
// (either instance, from the -DNFA_PROG=1 build).  Per (pattern,
// lane) the step writes the match count, and at the lane's last event
// with a match that event's ts and its lowest matched slot ([C*N, P]
// int32 each): no rows, no scratch.  The carry has a leading pattern axis
// and may be updated in place (carry in == carry out).
//
// What bounds the bank step: a new carry, the carry read once and
// written once, 2.0 GB each way at the fleet shape (1000 patterns x
// 10,000 lanes x K = 8: 8 slots x (4 int32 + 2 capture floats) + 2 lane
// words = 200 B a (pattern, lane)), 1.23 ms at 3.35 TB/s; the [P, T]
// block is 12.8 MB.  In place, what the data needs: every slot state
// read (0.32 GB), the starts of lanes that hold a partial, the slots that
// change written, the per-lane outputs written.
//
// Three instances, chosen per launch by ops/nfa.bank_geometry (the
// widened one, for the programs of ops/nfa.kernel_wide, is
// csrc/nfa_wide.cu's):
//  - nfa_bank_thread (K <= 16, at most 8 constant compares, shared memory
//    within the limit: every unit kind and condition program of the
//    bank's class): one thread per (pattern, lane).  It replaces the
//    group instance below on every main path, which lost its
//    time to instruction throughput, not bytes (47.26 ms a launch, 2.6%
//    of the bound): (1) 8 threads did one (pattern, lane)'s event work,
//    each decoding every event, running the constant compares through a
//    switch over ops in shared memory and taking two ballots per slot and
//    event; (2) each of the 313,000 CTAs staged its own copy of a lane
//    tile shared with 999 others, one 4-byte cp.async and one integer
//    division per word (12.8 GB through L2 a launch); (3) in the alert
//    band >= 99.85% of (pattern, lane, event) triples leave the constant
//    compares with no condition bit, yet ran the whole per-slot body.
//    What the design does about each:
//    (1) a thread holds its lane's K slots' state and start in registers
//        and their enter, seq and capture words in its own shared-memory
//        column; the first free and the lowest matched slot come from a
//        loop in slot order (jnp.argmax's order), no ballot; each
//        constant compare is an interval, `x <op> c` == (lo <= x <= hi)
//        != inv, exact on IEEE float32, computed once per pattern;
//    (2) a CTA is 8 warps over one tile of lanes, a warp = 32
//        consecutive lanes of one pattern: 8 patterns at a time share
//        one staged [32, TT] tile of ts, stream, gate word and attribute
//        lanes (the other mapping, a warp = 32 patterns of one lane, is
//        slower on the alert band and at T = 4, faster where most events
//        are live; tools/bank_probe.py times it from a build with
//        kBankLanes = 8).  When
//        one tile holds the whole block (T <= 64 at the fleet's two
//        attribute lanes), the CTA stages it, marks its candidates and
//        sets up its program once, then walks 4 groups of patterns over
//        it (32 patterns a CTA, 10,016 CTAs at the fleet shape); a longer
//        block is tiled over T, double buffered, one group a CTA (any T:
//        1, 4, thousands).  A lane row's TT words are a contiguous run in
//        each [P, T] array: 16-byte cp.async copies when T % 4 == 0 (else
//        4-byte), indices by shifts; rows padded to a stride of 4 (mod 8)
//        words.  The program, the CTA's constants and the carry's
//        columns arrive by cp.async too, so a CTA waits once on the
//        device's latency before its first event;
//    (3) the CTA takes the union of its patterns' intervals per compare
//        and marks, per lane and condition, the tile's candidate events:
//        valid, with the condition's bit left by the union (shared-memory
//        atomics, rare in the alert band).  An event that is no candidate
//        of a condition fails it for every pattern of the CTA: a thread
//        walks its lane's candidate bits of the conditions it can pass
//        only, applies its pattern's own intervals to them, and between
//        two live events only expires live slots (a live-slot bitmask;
//        none live: nothing), event by event.  Live events run the full
//        per-slot body in the plain step's order.  With absent units (a
//        template instance of its own) a slot's deadline sits in its
//        column, an arrival that passes the absent unit's condition kills
//        the partial, and the deadline pass runs after every live event
//        and, while a slot waits at an absent unit, at every valid dead
//        event too: a deadline fires on any event at or after it.  There
//        the conditions a thread can pass are unit 0's and those of the
//        units its slots wait at: config 3's kill condition (`kind == 0
//        and price > e2.price`) passes half the events, and walking them
//        for every thread made the step 11.69 ms a launch in place at
//        the fleet shape, against 1.25 when only a waiting slot reads it
//        (chip_smoke.py phase 11 on an NVIDIA H100 80GB HBM3, 700 W).
//    Kleene counts (the count instance, template flag CNT; with absent
//    units too when the spec has them): a thread keeps every word of a
//    slot in its column (state, start, enter, seq, cnt_cur, cnt_prev,
//    deadline, captures with their e[k] and e[last-j] banks) and rolls
//    its slot loops, so nfa_step.cuh's write_count, land and live_append
//    run once in the code through BankCaps' accessors; the plain step's
//    two passes become one loop over the slots in use (a bitmask in a
//    register: within, the conditions against the captures as they stand
//    before the event, the transition, the live appends) then arming
//    behind the occupancy gate (units 0..occ_hi) into the lowest slot
//    empty before the event or freed by it without a match.
//    The conditions a thread can pass are unit 0's, those of the units
//    its slots wait at and those of the counts a waiting slot's forwarded
//    count appends to: a slot at a count can wait at two units.  The
//    padding rows the plain step adds to a T that is no multiple of its
//    B expire, at the last event's ts, a slot that left a leading count
//    (state 0, which `within` spares) at the last event: one more
//    `within` pass there (pad_within).  A condition program runs per
//    slot on live events only, after the gate bit and the compare
//    tables, against the thread's pattern constants in shared memory.
//    Carry traffic: a thread's K = 8 slot words are 32 contiguous bytes
//    per leaf and its captures 64 B, loaded and stored with 16-byte
//    accesses (a warp reads 1 KB contiguous per leaf).  In place (the
//    fleet path) a thread reads its slot states and lane scalars, the
//    rest of its lane only if the lane holds a partial (a slot armed here
//    is written before it is read), and writes back only what changed:
//    in the alert band most of the 2.0 GB is neither read nor written.
//    In place needs no barrier: every thread reads its own carry words,
//    and only those, before it writes them.
//  - nfa_bank_step (K > 16, more than 8 constant compares, a column past
//    shared memory): the step body
//    above (a template flag, not a copy) over a grid of (lane tile, pattern),
//    pattern fastest; each pattern's constants come from a [C*N,
//    n_params] float32 table staged in shared memory; the lane's scalars
//    are read by every thread of its group, so they are written after a
//    barrier.  With count or absent units it runs the padding rows'
//    `within` pass (pad_within) as the plain step does.
//  - nfa_bank_step_wide (csrc/nfa_wide.cu: logical units, SEQUENCE, the
//    `every` forms, leading min-0 counts and absent units, telemetry, a
//    capture compare or program in the first condition): the same
//    grid and body with the widened unit loop (Wide::event) in place of
//    the two passes; a matched slot adds to its lane's count and the
//    event's lowest matched slot k (a ballot) and its ts become the
//    lane's last match; the telemetry rows are the CTA's pattern's.
//  - nfa_bank_ring: one CTA per pattern.  The exact top-ring of the P
//    lane counts by (count descending, lane ascending), lax.top_k's order,
//    and the pattern's total.  Bound by the bytes of the count rows (one
//    read of 4 P bytes a pattern), so each row is read from device memory
//    once: staged into shared memory by coalesced 16-byte cp.async copies
//    (a row too long for shared memory is walked in tiles, each tile read
//    once), and the sum, the bisection for the ring-th count and the
//    ballot compaction in lane order all read the staged tile; tiles'
//    lists merge in shared memory; then the gathers of the payload
//    (captures and slot start of the lane's last matched slot in the
//    final carry, its ts).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "nfa_bank.cuh"

namespace {

// One name per kernel, so a device trace keeps the step and the bank step
// apart.  EXT: the program has count or absent units (their carry words
// are passed); the other instance is the simple units' own.  (The
// widened instance is csrc/nfa_wide.cu's: a source of its own, so the
// two build in parallel.)
template <int SPT, bool EXT>
__global__ void __launch_bounds__(kThreads) nfa_step_kernel(StepArgs a) {
  step_body<SPT, false, EXT>(a, static_cast<int>(blockIdx.x));
}

template <int SPT, bool EXT>
__global__ void __launch_bounds__(kThreads)
    nfa_bank_step_kernel(StepArgs a) {
  step_body<SPT, true, EXT>(a, static_cast<int>(blockIdx.x));
}

#if !NFA_PROG
// (the compaction, the ring and the bank step's thread instance: the
// default build's alone)
__global__ void __launch_bounds__(kThreads) nfa_compact_kernel(PackArgs a) {
  compact_body(a, static_cast<int>(blockIdx.x));
}

// ------------------------------------------------------------ the bank ring

constexpr int kRingThreads = 256;
constexpr int kRingWarps = kRingThreads / 32;
constexpr int kRingRed = 2 * kRingWarps * 3;  // two reduction buffers

// The ring's dynamic shared memory in ints for a row of P lanes walked in
// tiles of `tile`: the reduction buffers; the tile (whole int4s; once the
// tile's selection is made, the merge's output list, so at least 2 ring);
// the tile's selection list (ring lanes and counts); and, when the row
// takes more than one tile, the running list of the tiles before it.
// ops/nfa.ring_geometry sizes it; the launch refuses a size below it.
__host__ __device__ inline long long ring_region_ints(int ring, int tile) {
  const long long whole = (static_cast<long long>(tile) + 3) / 4 * 4;
  return whole > 2LL * ring ? whole : 2LL * ring;
}

__host__ __device__ inline long long ring_layout_ints(int P, int ring,
                                                      int tile) {
  return kRingRed + ring_region_ints(ring, tile) +
         2LL * ring * (P > tile ? 2 : 1);
}

struct RingArgs {
  const int* count;       // [CN, P]
  const int* lmt;         // [CN, P]
  const int* lmk;         // [CN, P]
  const float* caps;      // [CN, P, K, RC], the final carry
  const int* start;       // [CN, P, K], the final carry
  int* total;             // [CN]
  int* rcnt;              // [CN, ring]
  int* rpid;              // [CN, ring]
  float* rcaps;           // [CN, ring, RC]
  int* rts;               // [CN, ring]
  unsigned char* rok;     // [CN, ring] (torch.bool)
  int P, K, RC, ring, tile;
};

__device__ __forceinline__ int lane4(const int4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// One CTA per pattern.  The row is walked in tiles (one tile, the whole
// row, whenever it fits in shared memory: the fleet's 10,000 lanes are
// 40 KB); each tile is read from device memory once, by coalesced 16-byte
// cp.async copies all in flight at once, into shared memory, and
// everything after reads it there:
//  1. the tile's sum, max and min (each thread over the words it copied,
//     warp reductions, one barrier);
//  2. the tile's k-th largest count v (k = min(ring, lanes)), exactly, by
//     bisection over [min, max]: a step is one pass over the staged tile
//     by 16-byte reads and one barrier.  Each warp owns a contiguous
//     range of the tile and keeps its own count at the final bounds, so
//     the step that settles v also gives every warp its lanes above v
//     and equal to v;
//  3. the selection in lane order: each warp walks its range in segments
//     of 32 int4 (128 lanes); four ballots per class (above v, equal to
//     v) give each lane's position, the warps' counts place the warps;
//     every lane above v is taken, then the lowest-index lanes equal to
//     v; a warp stops once it holds no more lanes above v and the lanes
//     equal to v are all placed;
//  4. the tile's list ordered (count descending, lane ascending) and
//     merged with the list of the tiles before it (every earlier lane
//     is lower, so it wins a tie): the top ring of a row is the top ring
//     of its tiles' top rings.
// Then the payload of the ring's lanes is gathered from the final carry.
__global__ void __launch_bounds__(kRingThreads, 5)
    nfa_bank_ring_kernel(RingArgs a) {
  extern __shared__ int4 rsm4[];
  int* red = reinterpret_cast<int*>(rsm4);              // [2][warps][3]
  int* tl = red + kRingRed;                             // the tile
  const int4* tl4 = reinterpret_cast<const int4*>(tl);
  int* lpid = tl + ring_region_ints(a.ring, a.tile);    // the tile's list
  int* lcnt = lpid + a.ring;
  int* rpid = lcnt + a.ring;                            // the running list
  int* rcnt = rpid + a.ring;
  int* opid = tl;                                       // the merged list
  int* ocnt = tl + a.ring;
  const int n = blockIdx.x, tid = threadIdx.x;
  const int wl = tid & 31, w = tid >> 5;
  const unsigned lt = (1u << wl) - 1u;
  const long long base = static_cast<long long>(n) * a.P;
  int par = 0;                                          // red buffer
  unsigned total = 0;
  int n_run = 0;                                        // running list

  for (int t0 = 0; t0 < a.P; t0 += a.tile) {
    const int nl = min(a.tile, a.P - t0);
    const int nch = (nl + 3) >> 2;
    const int* g = a.count + base + t0;
    const bool vec = (reinterpret_cast<uintptr_t>(g) & 15) == 0;

    // 1. stage the tile, every copy in flight at once (16 bytes where the
    // tile starts 16-byte aligned, else 4); each thread's sum, max and min
    // over the words it copied, once its own copies have landed
    for (int c = tid; c < nch; c += kRingThreads) {
      if (vec && 4 * c + 3 < nl) {
        cp_async16(tl + 4 * c, g + 4 * c);
      } else {
        for (int e = 0; e < 4 && 4 * c + e < nl; ++e)
          cp_async4(tl + 4 * c + e, g + 4 * c + e);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    unsigned sum = 0;
    int mx = INT_MIN, mn = INT_MAX;
    for (int c = tid; c < nch; c += kRingThreads) {
      const int4 v = tl4[c];
      const int m = nl - 4 * c;         // lanes of this int4 in the tile
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e >= m) break;
        const int x = lane4(v, e);
        sum += static_cast<unsigned>(x);
        mx = max(mx, x);
        mn = min(mn, x);
      }
    }
    sum = __reduce_add_sync(kFull, sum);
    mx = __reduce_max_sync(kFull, mx);
    mn = __reduce_min_sync(kFull, mn);
    int* rb = red + par * kRingWarps * 3;
    if (wl == 0) {
      rb[3 * w] = static_cast<int>(sum);
      rb[3 * w + 1] = mx;
      rb[3 * w + 2] = mn;
    }
    __syncthreads();                    // the tile and the stats are in
    sum = 0;
#pragma unroll
    for (int i = 0; i < kRingWarps; ++i) {
      sum += static_cast<unsigned>(rb[3 * i]);
      mx = max(mx, rb[3 * i + 1]);
      mn = min(mn, rb[3 * i + 2]);
    }
    par ^= 1;
    total += sum;
    if (a.ring <= 0) {
      __syncthreads();                  // the next tile overwrites this one
      continue;
    }

    // 2. v: the largest count with #(count >= v) >= k, by bisection over
    // the staged tile; this warp's range of int4s [c_lo, c_hi) and its
    // counts at lo and hi
    const int k = min(a.ring, nl);
    const int cpw = (nch + kRingWarps - 1) / kRingWarps;
    const int c_lo = min(nch, w * cpw), c_hi = min(nch, c_lo + cpw);
    int g_lo = max(0, min(4 * c_hi, nl) - 4 * c_lo), g_hi = 0;
    long long lo = mn, hi = static_cast<long long>(mx) + 1;
    while (hi - lo > 1) {
      const int mid = static_cast<int>(lo + (hi - lo) / 2);
      int ge = 0;
      for (int c = c_lo + wl; c < c_hi; c += 32) {
        const int4 v = tl4[c];
        const int m = nl - 4 * c;       // lanes of this int4 in the tile
        ge += (v.x >= mid) + (m > 1 && v.y >= mid) + (m > 2 && v.z >= mid) +
              (m > 3 && v.w >= mid);
      }
      ge = __reduce_add_sync(kFull, ge);
      rb = red + par * kRingWarps * 3;
      if (wl == 0) rb[3 * w] = ge;
      __syncthreads();
      int tot = 0;
#pragma unroll
      for (int i = 0; i < kRingWarps; ++i) tot += rb[3 * i];
      par ^= 1;
      if (tot >= k) {
        lo = mid;
        g_lo = ge;
      } else {
        hi = mid;
        g_hi = ge;
      }
    }
    const int v = static_cast<int>(lo);
    rb = red + par * kRingWarps * 3;
    if (wl == 0) {
      rb[3 * w] = g_hi;                 // lanes above v
      rb[3 * w + 1] = g_lo - g_hi;      // lanes equal to v
    }
    __syncthreads();
    int above = 0, ab = 0, eb = 0;
#pragma unroll
    for (int i = 0; i < kRingWarps; ++i) {
      above += rb[3 * i];
      if (i < w) {
        ab += rb[3 * i];
        eb += rb[3 * i + 1];
      }
    }
    par ^= 1;
    const int need = k - above;         // lanes equal to v taken, >= 1

    // 3. the selection, in lane order: above v at [0, above), then the
    // first `need` lanes equal to v
    int a_left = g_hi;
    for (int c0 = c_lo; c0 < c_hi && (a_left > 0 || eb < need); c0 += 32) {
      const int c = c0 + wl;
      const int4 v4 = c < c_hi ? tl4[c] : make_int4(0, 0, 0, 0);
      const int m = c < c_hi ? nl - 4 * c : 0;
      unsigned ba[4], bq[4];
      int pa = ab, pq = eb;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = lane4(v4, e);
        ba[e] = __ballot_sync(kFull, m > e && x > v);
        bq[e] = __ballot_sync(kFull, m > e && x == v);
        pa += __popc(ba[e] & lt);
        pq += __popc(bq[e] & lt);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lane = t0 + 4 * c + e;
        if ((ba[e] >> wl) & 1u) {
          lpid[pa] = lane;
          lcnt[pa] = lane4(v4, e);
          ++pa;
        }
        if ((bq[e] >> wl) & 1u) {
          if (pq < need) {
            lpid[above + pq] = lane;
            lcnt[above + pq] = v;
          }
          ++pq;
        }
      }
      int na = 0, nq = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        na += __popc(ba[e]);
        nq += __popc(bq[e]);
      }
      ab += na;
      a_left -= na;
      eb += nq;
    }
    __syncthreads();                    // the list is in; the tile is free

    // 4. order the tile's list and merge it with the running one into
    // the tile's space
    for (int j = tid; j < k; j += kRingThreads) {
      const int x = lcnt[j];
      int r = j;
      if (j < above) {
        r = 0;
        for (int i = 0; i < above; ++i) {
          const int y = lcnt[i];
          r += (y > x) || (y == x && i < j);
        }
      }
      int l = 0, h = n_run;             // running lanes with count >= x
      while (l < h) {
        const int md = (l + h) >> 1;
        if (rcnt[md] >= x) l = md + 1;
        else h = md;
      }
      r += l;
      if (r < a.ring) {
        opid[r] = lpid[j];
        ocnt[r] = x;
      }
    }
    for (int i = tid; i < n_run; i += kRingThreads) {
      const int x = rcnt[i];
      int r = i + (v > x ? k - above : 0);
      for (int q = 0; q < above; ++q) r += lcnt[q] > x;
      if (r < a.ring) {
        opid[r] = rpid[i];
        ocnt[r] = x;
      }
    }
    n_run = min(a.ring, n_run + k);
    __syncthreads();
    if (t0 + a.tile < a.P) {
      for (int i = tid; i < n_run; i += kRingThreads) {
        rpid[i] = opid[i];
        rcnt[i] = ocnt[i];
      }
      __syncthreads();                  // the next tile overwrites opid
    }
  }
  if (tid == 0) a.total[n] = static_cast<int>(total);
  if (a.ring <= 0) return;

  // the payload: the captures and slot start of each ring lane's last
  // matched slot in the final carry, and that match's ts
  for (int j = tid; j < a.ring; j += kRingThreads) {
    const int pid = opid[j];
    const long long ln = base + pid;
    const int kk = a.lmk[ln];
    const int tsv = a.lmt[ln];
    const long long sk = ln * a.K + kk;
    const long long o = static_cast<long long>(n) * a.ring + j;
    a.rcnt[o] = ocnt[j];
    a.rpid[o] = pid;
    a.rts[o] = tsv;
    a.rok[o] = a.start[sk] <= tsv ? 1 : 0;
    for (int i = 0; i < a.RC; ++i) a.rcaps[o * a.RC + i] = a.caps[sk * a.RC + i];
  }
}

#endif  // !NFA_PROG

// ------------------------------------- the bank step, a thread per lane

// this thread's slots in its shared-memory column: capture words (every
// instance), and the count instance's enter, seq, deadline and count
// words through the interface nfa_step.cuh's write_count, land and
// live_append take (Slots' accessors; xdl, xcc, xcp: the words' rows
// after the captures' K * RC)
struct BankCaps {
  float* cap;
  int RC, K, xdl, xcc, xcp;
  __device__ __forceinline__ float& c(int s, int i) {
    return cap[(s * RC + i) * kThreads];
  }
  __device__ __forceinline__ int cs() const { return kThreads; }
  __device__ __forceinline__ ColInt w(int row, int s) {
    return ColInt{cap[(K * RC + row + s) * kThreads]};
  }
  __device__ __forceinline__ ColInt enter(int s) { return w(0, s); }
  __device__ __forceinline__ ColInt seq(int s) { return w(K, s); }
  __device__ __forceinline__ ColInt dl(int s) { return w(xdl, s); }
  __device__ __forceinline__ ColInt cc(int s) { return w(xcc, s); }
  __device__ __forceinline__ ColInt cp(int s) { return w(xcp, s); }
};

// A thread's slot states and starts: registers (the slot loops unrolled)
// or, in the count instance, two rows of its shared-memory column (the
// loops rolled).
template <int KM, bool COL>
struct BankHot {
  int st_[KM], start_[KM];
  __device__ __forceinline__ int& st(int s) { return st_[s]; }
  __device__ __forceinline__ int& start(int s) { return start_[s]; }
};

template <int KM>
struct BankHot<KM, true> {
  float* col;             // the state row, then the start row
  int K;
  __device__ __forceinline__ ColInt st(int s) {
    return ColInt{col[s * kThreads]};
  }
  __device__ __forceinline__ ColInt start(int s) {
    return ColInt{col[(K + s) * kThreads]};
  }
};

// One thread per (pattern, lane), its K <= KM slots' state and start in
// registers, their enter, seq and capture words (ABS: and deadlines) in its
// shared-memory column; kBankLanes maps the threads.  ABS: the spec has
// absent units (kills, deadlines, the deadline pass).  CNT: the spec has
// kleene count units, and absent units when a.absent: every word of a
// slot in its column (state, start, cnt_cur and cnt_prev too), the slot
// loops rolled (their body runs nfa_step.cuh's write_count, land and
// live_append through BankCaps; unrolled KM times it would not fit the
// instruction cache), arming gated by the occupancy of units 0..occ_hi.
// In the -DNFA_PROG=1 build a condition's program runs against the slot's
// captures and the thread's pattern constants.
template <int KM, bool ABS, bool CNT>
__global__ void __launch_bounds__(kThreads, KM <= 8 ? 3 : 2)
    nfa_bank_thread_kernel(BankArgs a) {
  constexpr int LT = kBankLanes;                  // lanes of the tile
  constexpr int NPC = kThreads / LT;              // patterns of a group
  constexpr int UR = CNT ? 1 : KM;                // slot loops unrolled
  extern __shared__ int smem[];
  const int tid = threadIdx.x, wl = tid & 31, w = tid >> 5;
  const int l = LT == 32 ? wl : w;
  const int pi = LT == 32 ? w : wl;               // pattern in a group
  const int NG = NPC * a.groups;                  // patterns of the CTA
  const int pat0 = blockIdx.y * NG;
  const int p0 = blockIdx.x * LT;
  const int p = p0 + l;
  const int NA = 3 + a.A;
  const int RC = a.RC, K = a.K;
  // deadlines: the absent instance's, or the count instance's when the
  // spec has absent units too
  const bool XA = ABS || (CNT && a.absent);
  const BankLayout lay = bank_layout(a);
  int* sprog = smem;
  // the CTA's patterns' constants, [NG, n_params]
  float* sprm = reinterpret_cast<float*>(smem + lay.prm);
  // per compare q: each pattern's entry (q * NG + n) and the CTA's union
  // (kBankMaxPcmp * NG + q): lo, hi, attribute offset, bits
  float4* spc = reinterpret_cast<float4*>(smem + lay.pc);
  int* tiles = smem + lay.tiles;
  float* col = reinterpret_cast<float*>(smem + lay.col) + tid;
  BankCaps sl;
  sl.cap = col;
  sl.RC = RC;
  sl.K = K;
  sl.xdl = 2 * K;
  sl.xcc = (2 + a.absent) * K;
  sl.xcp = sl.xcc + K;
  float* scol = col + K * RC * kThreads;          // enter, seq, deadline
#define ENTER(s) scol[(s) * kThreads]
#define SEQ(s) scol[(K + (s)) * kThreads]
#define DL(s) scol[(2 * K + (s)) * kThreads]
  BankHot<KM, CNT> h;
  if constexpr (CNT) {
    h.col = scol + (sl.xcp + K) * kThreads;
    h.K = K;
  }

  // the program and the constants, then the first tile, in flight with
  // the carry's loads: one wait on the device's latency
  for (int i = tid; i < a.prog_len; i += kThreads)
    cp_async4(sprog + i, a.prog + i);
  for (int i = tid; i < NG * a.n_params; i += kThreads) {
    const int n = pat0 + i / a.n_params;
    if (n < a.CN)
      cp_async4(sprm + i, a.params + static_cast<long long>(n) *
                                         a.n_params + i % a.n_params);
  }
  cp_async_commit();
  bank_stage<LT>(tiles, 0, a, p0);
  cp_async_commit();

  // a group's carry: the slot states and the lane's scalars; the rest
  // (start, enter, seq, captures, deadlines, count words) not in place,
  // or in place for a lane that holds a partial: a slot armed here is
  // written before it is read, so an empty lane needs none of its cold
  // words.  cold: every slot's cold words are in; else only those of the
  // slots in dmask (armed or advanced here) and the deadlines in dlmask
  // (set here); dirty: the lane changed
  const bool inplace = a.inplace;
  int pat = 0, arm_seq = 0, drop = 0, armed = 0;
  long long lane = 0, lk = 0;
  bool on = false, cold = false, dirty = false;
  unsigned dmask = 0, dlmask = 0;
  auto load_group = [&](int r) {
    pat = pat0 + r * NPC + pi;
    on = p < a.P && pat < a.CN;
    lane = static_cast<long long>(pat) * a.P + p;
    lk = lane * K;
    cold = dirty = false;
    dmask = dlmask = 0;
    if constexpr (CNT) {
#pragma unroll 1
      for (int s = 0; s < K; ++s) h.st(s) = -1;
      if (!on) return;
      int v[KM];
      load_words<KM>(v, a.st_in + lk, K, a.vec_slots);
#pragma unroll
      for (int s = 0; s < KM; ++s) {
        if (s >= K) break;
        h.st(s) = v[s];
      }
    } else {
#pragma unroll
      for (int s = 0; s < KM; ++s) {
        h.st(s) = -1;
        h.start(s) = 0;
      }
      if (!on) return;
      load_words<KM>(h.st_, a.st_in + lk, K, a.vec_slots);
    }
    arm_seq = a.armseq_in[lane];
    drop = a.dropped_in[lane];
    if (a.armed_in) armed = a.armed_in[lane];
    cold = !inplace;
#pragma unroll (UR)
    for (int s = 0; s < KM; ++s) {
      if (CNT && s >= K) break;
      cold |= h.st(s) >= 0;
    }
    if (cold) {
      if constexpr (CNT) load_col(h.col + K * kThreads, a.start_in + lk, K);
      else load_words<KM>(h.start_, a.start_in + lk, K, a.vec_slots);
      load_col(&ENTER(0), a.enter_in + lk, K);
      load_col(&SEQ(0), a.seq_in + lk, K);
      if (XA) load_col(&DL(0), a.dl_in + lk, K);
      if constexpr (CNT) {
        load_col(scol + sl.xcc * kThreads, a.cc_in + lk, K);
        load_col(scol + sl.xcp * kThreads, a.cp_in + lk, K);
      }
      load_col(col, a.caps_in + lk * RC, K * RC);
    }
  };
  load_group(0);                        // while the first tile lands
  cp_async_commit();                    // waited with the first tile
  cp_async_wait<2>();
  __syncthreads();                      // the program is in shared memory

  Prog g = parse(sprog);
  // the caller picks the instance: more constant compares run on the
  // group instance (ops/nfa.bank_geometry), condition programs in the
  // -DNFA_PROG=1 build (the default build's code has none)
  if (g.n_pcmp > kBankMaxPcmp) __trap();
  if constexpr (!kProg) {
    if (g.np) __trap();
    g.np = 0;
  }
  const Arm arm = arm_of(g);
  BankCta<LT> cta{a, spc, smem + lay.mask, NG, g.n_pcmp, l};
  cta.intervals(g, sprm, pat0);
  __syncthreads();
  cta.join();

  const unsigned cmask = (1u << g.n_cond) - 1u;
  const int* u0 = unit(g, 0);
  const int tt_sh = __ffs(a.TT) - 1;
  auto is_absent = [&](int j) { return unit(g, j)[uKind] == kAbsent; };
  // bit s: slot s holds a partial (live), waits at an absent unit
  // (wait); the count instance: is not empty (used, state 0 included)
  unsigned live = 0, wait = 0, used = 0;
  auto masks = [&]() {
    live = wait = 0;
    if constexpr (CNT) used = 0;
#pragma unroll (UR)
    for (int s = 0; s < KM; ++s) {
      if (CNT && s >= K) break;
      const int x = h.st(s);
      if (x >= 1) live |= 1u << s;
      if (XA && x >= 1 && is_absent(x)) wait |= 1u << s;
      if (CNT && x >= 0) used |= 1u << s;
    }
  };
  int cnt = 0, lmt = 0, lmk = 0;
  // the deadline pass at a valid event at tsv: each slot waiting at an
  // absent unit whose deadline is at or before tsv lands at its
  // deadline (nfa_step.cuh's land: count words reset), cascading through
  // absent units; a trailing one completes
  auto deadlines = [&](int tsv, int& ev_k) {
#pragma unroll (UR)
    for (int s = 0; s < KM; ++s) {
      if (CNT && s >= K) break;
      if (!((wait >> s) & 1u)) continue;
      int sts = h.st(s);
      while (sts >= 1 && is_absent(sts) &&
             __float_as_int(DL(s)) <= tsv) {
        const int base = __float_as_int(DL(s));
        const int t = unit(g, sts)[uLand];
        dmask |= 1u << s;
        dirty = true;
        if (t >= g.S) {
          sts = -1;
          ++cnt;
          if (ev_k < 0 || s < ev_k) ev_k = s;
        } else {
          if constexpr (CNT) {
            sl.cc(s) = 0;
            sl.cp(s) = unit(g, sts)[uLive0] ? 0 : -1;
          }
          sts = t;
          ENTER(s) = __int_as_float(base);
          if (is_absent(t)) {
            DL(s) = __int_as_float(add32(base, unit(g, t)[uWait]));
            dlmask |= 1u << s;
          }
        }
      }
      h.st(s) = sts;
    }
  };

  // the conditions a thread can pass now: with absent or count units,
  // those of unit 0 and of the units its slots wait at, and of the count
  // units a waiting slot's forwarded count appends to (an absent unit's
  // kill condition passes most events, and only a slot waiting there
  // reads it; a count's closing unit likewise); else every condition, as
  // simple units' conditions rarely pass
  auto needs = [&]() {
    if (!ABS && !CNT) return cmask;
    unsigned r = 1u << u0[uCond];
    if constexpr (CNT) {
      for (unsigned b = used; b; b &= b - 1) {
        const int x = h.st(__ffs(b) - 1);
        if (x < 0) continue;
        const int* u = unit(g, x);
        r |= 1u << u[uCond];
        if (u[uApp0] >= 0) r |= 1u << unit(g, u[uApp0])[uCond];
        if (u[uApp1] >= 0) r |= 1u << unit(g, u[uApp1])[uCond];
      }
      return r;
    }
#pragma unroll
    for (int s = 0; s < KM; ++s) {
      const int x = h.st(s);
      if (x < 0) continue;
      r |= 1u << unit(g, x)[uCond];
    }
    return r;
  };

  const int n_tiles = (a.T + a.TT - 1) / a.TT;
  for (int r = 0; r < a.groups; ++r) {  // groups > 1: one tile, staged once
    if (r > 0) {
      load_group(r);
      cp_async_commit();
      cp_async_wait<0>();
    }
    masks();
    cnt = lmt = lmk = 0;
    const int n = r * NPC + pi;           // this pattern in the CTA
    if constexpr (kProg) g.prm = sprm + n * a.n_params;
    for (int it = 0; it < n_tiles; ++it) {
      const int* cur = tiles + (it & 1) * NA * a.arr;
      const int tn = min(a.TT, a.T - it * a.TT);
      if (r == 0) {
        if (it + 1 < n_tiles) {
          bank_stage<LT>(tiles + ((it + 1) & 1) * NA * a.arr, (it + 1) * a.TT,
                         a, p0);
          cp_async_commit();
        }
        for (int i = tid; i < g.n_cond * cta.mstride; i += kThreads)
          cta.smask[i] = 0;
        if (it + 1 < n_tiles) cp_async_wait<1>();
        else cp_async_wait<0>();
        __syncthreads();
        cta.mark(cmask, cur, tn, p0, tt_sh);
        __syncthreads();
      }
      const int* row = cur + l * a.stride;
      for (int wd = 0; on && wd < ((tn + 31) >> 5); ++wd) {
        const int jb = wd << 5, je = min(tn, jb + 32);
        // the conditions this thread can pass now: unit 0's (arming) and
        // those of the units its slots wait at; an event that passes none
        // of them is dead for it.  need only grows inside a word: when a
        // slot reaches a unit whose condition it lacks, the word's live
        // events from there on are found again
        unsigned need = needs();
        unsigned al = cta.live_from(row, wd, jb, need, n);
        if (!al && !(g.has_within && live) && !wait) continue;
        // in event order: each dead event expires live slots (`within`)
        // and, when valid, runs the deadline pass; a live event takes the
        // plain step's order — within, each slot's one transition, then
        // arming, then the deadline pass
        for (int j = jb;;) {
          const int jn = al ? jb + __ffs(al) - 1 : je;
          bool grew = false;
          for (; !grew && ((g.has_within && live) || wait) && j < jn; ++j) {
            const int tsv = row[j];
            if (g.has_within) {
#pragma unroll (UR)
              for (int s = 0; s < KM; ++s) {
                if (CNT && s >= K) break;
                if (((live >> s) & 1u) &&
                    sub32(tsv, h.start(s)) > g.within) {
                  h.st(s) = -1;
                  live &= ~(1u << s);
                  wait &= ~(1u << s);
                  dirty = true;
                }
              }
            }
            if (XA && wait && (row[2 * a.arr + j] & kValidBit)) {
              int ev_k = -1;
              deadlines(tsv, ev_k);
              if (ev_k >= 0) {
                lmt = tsv;
                lmk = ev_k;
              }
              masks();
              const unsigned nn = needs();
              grew = (nn & ~need) != 0;
              need |= nn;
            }
          }
          if (grew) {
            al = cta.live_from(row, wd, j, need, n);
            continue;
          }
          if (jn >= je) break;
          al &= al - 1;
          j = jn + 1;
          dirty = true;
          const unsigned gw = cta.gate(row, jn, n);
          const int tsv = row[jn];
          const int sv = row[a.arr + jn];
          const float* at =
              reinterpret_cast<const float*>(row + 3 * a.arr + jn);
          int ffree = -1;                 // first free slot
          int ev_k = -1;                  // lowest slot matched now
          if constexpr (CNT) {
            // step_body's two passes in one, slot by slot: within, the
            // slot's conditions against its captures as they stand
            // before the event (its unit's, and those of the count
            // units its forwarded count appends to), its one transition
            // (a simple unit advances or completes, a count unit
            // appends and advances at min, an absent unit's arrival
            // kills), the live appends; then arming, unless a slot
            // sits at units 0..occ_hi.  Only the slots in use are
            // walked: the first free slot is the lowest one empty before
            // the event or freed by it without a match
            bool occ = false;
            unsigned freed = 0;
#pragma unroll 1
            for (unsigned b = used; b; b &= b - 1) {
              const int s = __ffs(b) - 1;
              int sts = h.st(s);
              bool m = false;
              if (g.has_within && sts >= 1 &&
                  sub32(tsv, h.start(s)) > g.within)
                sts = -1;
              occ |= sts >= 0 && sts <= g.occ_hi;
              if (sts >= 0) {
                const int* u = unit(g, sts);
                const int a0 = u[uApp0], a1 = u[uApp1];
                const bool ok = sv == u[uStream] &&
                                cond_ok(g, u[uCond], gw, sl, s, at, a.arr);
                const bool ok0 =
                    a0 >= 0 && sv == unit(g, a0)[uStream] &&
                    cond_ok(g, unit(g, a0)[uCond], gw, sl, s, at, a.arr);
                const bool ok1 =
                    a1 >= 0 && sv == unit(g, a1)[uStream] &&
                    cond_ok(g, unit(g, a1)[uCond], gw, sl, s, at, a.arr);
                bool adv = false;
                if (ok) {
                  const int from = sts;
                  if (u[uKind] == kSimple) {
                    if (u[uRow] >= 0) write_row(g, u[uRow], sl, s, at, a.arr);
                    m = land(g, sl, s, sts, from, tsv, false, 0, false);
                    adv = true;
                  } else if (u[uKind] == kCount) {
                    const int c2 = sl.cc(s) + 1;
                    if (u[uRow] >= 0)
                      write_count(g, u[uRow], sl, s, at, a.arr, c2 == 1, c2);
                    sl.cc(s) = c2;
                    if (c2 == u[uMin]) {
                      m = land(g, sl, s, sts, from, tsv, true, c2,
                               c2 == u[uMax]);
                      adv = true;
                    }
                  } else {
                    sts = -1;             // an absent unit's arrival kills
                  }
                  if (XA && adv && !m && is_absent(sts)) dlmask |= 1u << s;
                }
                if (!adv) {
                  live_append(g, sl, s, a0, ok0, at, a.arr);
                  live_append(g, sl, s, a1, ok1, at, a.arr);
                }
                if (ok || ok0 || ok1) dmask |= 1u << s;
              }
              h.st(s) = sts;
              if (sts < 0 && !m) freed |= 1u << s;
              if (m) {
                ++cnt;
                if (ev_k < 0) ev_k = s;
              }
            }
            const unsigned fr = (~used | freed) & ((2u << (K - 1)) - 1u);
            ffree = fr ? __ffs(fr) - 1 : -1;
            const bool want = sv == u0[uStream] &&
                              ((gw >> u0[uCond]) & 1u) && !occ &&
                              (!g.arm_once || armed == 0);
            if (want) {
              if (ffree >= 0) {
                const int f = ffree;
                if (g.arm_once) armed += 1;
                for (int i = 0; i < RC; ++i) sl.c(f, i) = 0.0f;
                if (u0[uRow] >= 0) {
                  if (u0[uKind] == kCount)
                    write_count(g, u0[uRow], sl, f, at, a.arr, true, 1);
                  else
                    write_row(g, u0[uRow], sl, f, at, a.arr);
                }
                h.start(f) = tsv;
                if (arm.match) {          // completes as it arms; the slot
                  ++cnt;                  // stays empty
                  if (ev_k < 0 || f < ev_k) ev_k = f;
                } else {
                  h.st(f) = arm.state;
                  sl.enter(f) = tsv;
                  sl.seq(f) = arm_seq;
                  sl.cc(f) = arm.cnt_cur;
                  sl.cp(f) = arm.cnt_prev;
                  if (XA && arm.deadline) {
                    sl.dl(f) = add32(tsv, unit(g, arm.state)[uWait]);
                    dlmask |= 1u << f;
                  }
                }
                dmask |= 1u << f;
                arm_seq += 1;
              } else {
                drop += 1;
              }
            }
          } else {
#pragma unroll
            for (int s = 0; s < KM; ++s) {
              if (s >= K) break;
              int sts = h.st(s);
              bool m = false;
              if (g.has_within && sts >= 1 &&
                  sub32(tsv, h.start(s)) > g.within)
                sts = -1;
              if (sts >= 0 && sts < g.S) {
                const int* u = unit(g, sts);
                if (sv == u[uStream] &&
                    cond_ok(g, u[uCond], gw, sl, s, at, a.arr)) {
                  if (ABS && u[uKind] == kAbsent) {
                    sts = -1;             // the arrival kills the partial
                  } else {
                    if (u[uRow] >= 0) write_row(g, u[uRow], sl, s, at, a.arr);
                    const int t = u[uLand];
                    if (t >= g.S) {
                      m = true;
                      sts = -1;
                    } else {
                      sts = t;
                      ENTER(s) = __int_as_float(tsv);
                      if (ABS && is_absent(t)) {
                        DL(s) = __int_as_float(add32(tsv, unit(g, t)[uWait]));
                        dlmask |= 1u << s;
                      }
                    }
                    dmask |= 1u << s;
                  }
                }
              }
              h.st(s) = sts;
              if (ffree < 0 && sts < 0 && !m) ffree = s;
              if (m) {
                ++cnt;
                if (ev_k < 0) ev_k = s;
              }
            }
            // arming at unit 0: the first free slot, free meaning empty
            // and not completed by this event
            const bool want = sv == u0[uStream] &&
                              ((gw >> u0[uCond]) & 1u) &&
                              (!g.arm_once || armed == 0);
            if (want) {
              if (ffree >= 0) {
                if (g.arm_once) armed += 1;
                for (int i = 0; i < RC; ++i) sl.c(ffree, i) = 0.0f;
                if (u0[uRow] >= 0)
                  write_row(g, u0[uRow], sl, ffree, at, a.arr);
#pragma unroll
                for (int s = 0; s < KM; ++s) {
                  if (s != ffree) continue;
                  h.start(s) = tsv;
                  if (g.S > 1) h.st(s) = 1;
                }
                if (g.S > 1) {
                  ENTER(ffree) = __int_as_float(tsv);
                  SEQ(ffree) = __int_as_float(arm_seq);
                  if (ABS && is_absent(1)) {
                    DL(ffree) = __int_as_float(add32(tsv, unit(g, 1)[uWait]));
                    dlmask |= 1u << ffree;
                  }
                }
                dmask |= 1u << ffree;
                arm_seq += 1;
                if (g.S == 1) {           // completes as it arms; the slot
                                          // stays empty
                  ++cnt;
                  if (ev_k < 0 || ffree < ev_k) ev_k = ffree;
                }
              } else {
                drop += 1;
              }
            }
          }
          masks();
          if (XA && wait) {
            deadlines(tsv, ev_k);
            masks();
          }
          if (ev_k >= 0) {
            lmt = tsv;
            lmk = ev_k;
          }
          if constexpr (ABS || CNT) {
            const unsigned nn = needs();
            if (nn & ~need) {
              need |= nn;
              al = cta.live_from(row, wd, j, need, n);
            }
          }
        }
      }
      if (n_tiles > 1) __syncthreads();   // the tile is free to refill
    }
    if constexpr (CNT) {
      // the plain step's padding rows (invalid, at the last event's ts)
      // run only the `within` expiry: once more at that ts.  A slot that
      // left unit 0's count (state 0, which `within` spares) at the last
      // event may expire there; in the other instances no slot can
      if (a.pad_within && on && g.has_within && a.T > 0) {
        const int tl = a.ts[static_cast<long long>(p) * a.T + a.T - 1];
#pragma unroll 1
        for (int s = 0; s < K; ++s) {
          if (h.st(s) >= 1 && sub32(tl, h.start(s)) > g.within) {
            h.st(s) = -1;
            dirty = true;
          }
        }
      }
    }

    if (!on) continue;
    // in place needs no barrier: these words were read by this thread alone;
    // in place, words that did not change are not written
    if (!inplace || dirty) {
      if constexpr (CNT) store_col(h.col, a.st + lk, K, a.vec_slots);
      else store_words<KM>(h.st_, a.st + lk, K, a.vec_slots);
      a.armseq[lane] = arm_seq;
      a.dropped[lane] = drop;
      if (g.arm_once) a.armed[lane] = armed;
    }
    if (cold) {
      if constexpr (CNT)
        store_col(h.col + K * kThreads, a.start + lk, K, a.vec_slots);
      else
        store_words<KM>(h.start_, a.start + lk, K, a.vec_slots);
      store_col(&ENTER(0), a.enter + lk, K, a.vec_slots);
      store_col(&SEQ(0), a.seq + lk, K, a.vec_slots);
      if (XA) store_col(&DL(0), a.dl + lk, K, a.vec_slots);
      if constexpr (CNT) {
        store_col(scol + sl.xcc * kThreads, a.cc + lk, K, a.vec_slots);
        store_col(scol + sl.xcp * kThreads, a.cp + lk, K, a.vec_slots);
      }
      store_col(col, a.caps + lk * RC, K * RC, a.vec_caps);
    } else {
#pragma unroll (UR)
      for (int s = 0; s < KM; ++s) {
        if (CNT && s >= K) break;
        if (XA && ((dlmask >> s) & 1u))
          a.dl[lk + s] = __float_as_int(DL(s));
        if (!((dmask >> s) & 1u)) continue;
        a.start[lk + s] = h.start(s);
        // a one-unit arm sets neither (a slot is never occupied then)
        if (CNT ? !arm.match : g.S > 1) {
          a.enter[lk + s] = __float_as_int(ENTER(s));
          a.seq[lk + s] = __float_as_int(SEQ(s));
          if constexpr (CNT) {
            a.cc[lk + s] = sl.cc(s);
            a.cp[lk + s] = sl.cp(s);
          }
        }
        for (int i = 0; i < RC; ++i)
          a.caps[(lk + s) * RC + i] = sl.c(s, i);
      }
    }
    a.count[lane] = cnt;
    a.lmt[lane] = lmt;
    a.lmk[lane] = lmk;
  }
#undef ENTER
#undef SEQ
#undef DL
}

// ------------------------------------------------------------ launches

template <int SPT, bool BANK, bool EXT>
int launch_step(const StepArgs& a, size_t smem, long long grid,
                cudaStream_t s) {
  if (grid <= 0) return 0;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  void (*const kern)(StepArgs) =
      BANK ? nfa_bank_step_kernel<SPT, EXT> : nfa_step_kernel<SPT, EXT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Tile size, slot instance and shared memory for a, then the launch over
// ceil(P / L) lane tiles (times CN patterns for the bank).
template <bool BANK, bool EXT>
int run_step_as(StepArgs& a, cudaStream_t s) {
  const StepPlan p = plan_step(a, BANK, kSmemLimit);
  if (p.smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid =
      static_cast<long long>((a.P + a.L - 1) / a.L) * (BANK ? a.CN : 1);
  if (p.spt == 1) return launch_step<1, BANK, EXT>(a, p.smem, grid, s);
  if (p.spt == 2) return launch_step<2, BANK, EXT>(a, p.smem, grid, s);
  if (p.spt == 4) return launch_step<4, BANK, EXT>(a, p.smem, grid, s);
  return launch_step<0, BANK, EXT>(a, p.smem, grid, s);
}

// the instance for the carry: count or deadline words passed, or not (a
// widened program launches through csrc/nfa_wide.cu)
template <bool BANK>
int run_step(StepArgs& a, cudaStream_t s) {
  if (a.wide) return static_cast<int>(cudaErrorInvalidValue);
  return a.cc_in || a.dl_in ? run_step_as<BANK, true>(a, s)
                            : run_step_as<BANK, false>(a, s);
}

// the thread instance for K's slot bound, ABS and CNT
template <bool ABS, bool CNT>
int launch_thread(const BankArgs& a, size_t smem, cudaStream_t s) {
  void (*const k)(BankArgs) =
      a.K <= 4   ? nfa_bank_thread_kernel<4, ABS, CNT>
      : a.K <= 8 ? nfa_bank_thread_kernel<8, ABS, CNT>
                 : nfa_bank_thread_kernel<16, ABS, CNT>;
  return launch_bank(k, a, smem, s);
}
}  // namespace


// Launch one block step on `stream` (a program of the simple or count and
// absent instances; csrc/nfa_wide.cu's nfa_step_wide takes the widened
// ones, with this signature).  G (threads per lane: K rounded up
// to a power of two, at most 32) and seg (scratch rows per CTA) come from
// the caller, which sizes rows as ceil(P / (256 / G)) * seg * (6 + RC)
// int32, and fill and dl_min (null without absent units) as one int32 a
// CTA.  Returns cudaGetLastError() after the launch (0 = cudaSuccess);
// the caller raises on anything else.
extern "C" int nfa_step(const float* attrs, const int* ts, const int* strm,
                        const int* gates, const int* prog, int prog_len,
                        CARRY_PARAMS, int* rows, int* lane_count, int* fill,
                        int* dl_min, const int* lm_in, const int* sf_in,
                        const int* tel_in, int* lm, int* sf, int* tel, int P,
                        int T, int K, int G, int seg, int A, int RC,
                        int flags, int tel_w, void* stream) {
  if (P <= 0) return 0;
  StepArgs a{};
  const int* const win[3] = {lm_in, sf_in, tel_in};
  int* const wout[3] = {lm, sf, tel};
  if ((flags & kFlagWide) ||
      !make_step_args(a, attrs, ts, strm, gates, prog, prog_len, CARRY_IN,
                      CARRY_OUT, rows, lane_count, fill, dl_min, win, wout,
                      P, T, K, G, seg, A, RC, flags, tel_w))
    return static_cast<int>(cudaErrorInvalidValue);
  return run_step<false>(a, static_cast<cudaStream_t>(stream));
}

// Launch the bank step's group instance over CN patterns on `stream`:
// carry leaves [CN, P, K(, RC)] and [CN, P] (in and out may be the same
// tensors), params [CN, n_params] float32, outputs count, lmt, lmk [CN, P]
// int32, and pad_within (ops/nfa.kernel_flags' FLAG_PAD_WITHIN: one more
// `within` pass at the last event's ts, as the plain step's padding rows
// run it).  A widened program launches through csrc/nfa_wide.cu's
// nfa_bank_step_wide.  Returns cudaGetLastError() after the launch.
extern "C" int nfa_bank_step(const float* attrs, const int* ts,
                             const int* strm, const int* gates,
                             const int* prog, int prog_len,
                             const float* params, int n_params, CARRY_PARAMS,
                             int* count, int* lmt, int* lmk, int CN, int P,
                             int T, int K, int G, int A, int RC,
                             int pad_within, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 0 || CN <= 0) return 0;
  StepArgs a{};
  const int* const win[3] = {nullptr, nullptr, nullptr};
  int* const wout[3] = {nullptr, nullptr, nullptr};
  if (!make_bank_args(a, attrs, ts, strm, gates, prog, prog_len, params,
                      n_params, CARRY_IN, CARRY_OUT, count, lmt, lmk, win,
                      wout, CN, P, T, K, G, A, RC,
                      pad_within ? kFlagPadWithin : 0, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return run_step<true>(a, s);
}

// Launch the bank step's thread instance (one thread per (pattern, lane),
// K <= 16, at most 8 constant compares; condition programs from the
// -DNFA_PROG=1 build) over CN patterns on `stream`: the arguments of
// nfa_bank_step, with TT (events a staged tile: a power of two >= 4) for
// G, smem (the CTA's shared memory in bytes, at least bank_layout's) and
// groups (the pattern groups a CTA walks over its staged tile; above 1
// only when one tile holds T), all three from ops/nfa.bank_geometry, and
// n_cond (the program's conditions: one candidate mask each in shared
// memory), and pad_within (ops/nfa.kernel_flags' FLAG_PAD_WITHIN: one
// more `within` pass at the last event's ts, as the plain step's padding
// rows run it; of the thread instances the count instance alone reads
// it, as a `within` pass there can expire only a slot that left a
// leading count at the last event; the group instance (nfa_bank_step)
// and the widened one (csrc/nfa_wide.cu's nfa_bank_step_wide) run it for
// every spec with count or absent units).  Count leaves (cc_in, cp_in)
// select the count instance, which
// also takes a deadline leaf; a deadline leaf alone the instance with
// absent units.  Returns cudaGetLastError() after the launch.
extern "C" int nfa_bank_thread(const float* attrs, const int* ts,
                               const int* strm, const int* gates,
                               const int* prog, int prog_len,
                               const float* params, int n_params,
                               CARRY_PARAMS, int* count, int* lmt, int* lmk,
                               int CN, int P, int T, int K, int TT, int A,
                               int RC, int smem, int groups, int n_cond,
                               int pad_within, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 0 || CN <= 0) return 0;
  BankArgs a{};
  if (!make_thread_args(a, attrs, ts, strm, gates, prog, prog_len, params,
                        n_params, CARRY_IN, CARRY_OUT, count, lmt, lmk, CN,
                        P, T, K, TT, A, RC, groups, n_cond, pad_within))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<size_t>(smem) > kSmemLimit ||
      static_cast<long long>(bank_layout(a).end) * 4 > smem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.counts) return launch_thread<false, true>(a, smem, s);
  if (a.absent) return launch_thread<true, false>(a, smem, s);
  return launch_thread<false, false>(a, smem, s);
}

#if !NFA_PROG

// The compaction of one step's scratch into the slab [cap + 2, W] (rows,
// tail, status); dl_min (the step's per-CTA earliest absent deadlines, or
// null) gives the tail's column 2.  Returns cudaGetLastError() after the
// launch.
extern "C" int nfa_compact(const int* rows, const int* lane_count,
                           const int* fill, const int* dropped,
                           const int* dl_min, int* slab, int P, int L,
                           int seg, int n_cta, int cap, int W,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P <= 0 || n_cta <= 0 || L <= 0 || L > kThreads || cap < 0 || W < 5 ||
      seg < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  PackArgs a{rows, lane_count, fill, dropped, dl_min, slab,
             P, L, seg, n_cta, cap, W};
  nfa_compact_kernel<<<n_cta, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The bank's match ring: per pattern, the total and the top-ring lanes
// with their payload (ring 0: the totals alone).  ring <= P; the row is
// walked in tiles of `tile` lanes in `smem` bytes of dynamic shared
// memory (ops/nfa.ring_geometry), checked here against the kernel's
// layout.  Returns cudaGetLastError() after the launch.
extern "C" int nfa_bank_ring(const int* count, const int* lmt, const int* lmk,
                             const float* caps, const int* start, int* total,
                             int* ring_cnt, int* ring_pid, float* ring_caps,
                             int* ring_ts, unsigned char* ring_ok, int CN,
                             int P, int K, int RC, int ring, int tile,
                             int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (CN <= 0) return 0;
  if (P <= 0 || K <= 0 || RC <= 0 || ring < 0 || ring > P || tile <= 0 ||
      smem < 0 || static_cast<size_t>(smem) > kSmemLimit ||
      ring_layout_ints(P, ring, tile) * 4 > smem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nfa_bank_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  RingArgs a{count, lmt, lmk, caps, start, total, ring_cnt, ring_pid,
             ring_caps, ring_ts, ring_ok, P, K, RC, ring, tile};
  nfa_bank_ring_kernel<<<CN, kRingThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

#endif  // !NFA_PROG