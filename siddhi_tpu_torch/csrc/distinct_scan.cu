// distinct_scan: the per-group running multiset of distinctCount and
// unionSet, one warp per group.
//
// Replaces siddhi_tpu/ops/aggregators.py:291 (_apply_distinct), the
// lax.scan over every row of a batch that XLA lowered to a sequential
// loop on the device. It is not a Pallas kernel. Row by row in arrival
// order, each group keeps an open table of H (value code, count) slots:
//
//   - a row whose epoch differs from its group's stamp reads the table as
//     empty (a RESET between the two cleared it lazily);
//   - slot = the lowest slot whose count > 0 and whose key is the row's
//     value, else the lowest slot whose count <= 0; none: the table is
//     full, the row does not apply and the overflow flag is set;
//   - an applying row writes key and max(count + delta, 0) into the slot
//     (delta +1 for CURRENT, -1 for EXPIRED) and stamps the group;
//   - every row reports the number of live (count > 0) slots after it,
//     and for unionSet the table's keys and live mask as a [H] snapshot;
//   - a multi-element set input folds its elements into one row, in order.
//
// Bound: the serial chain of the largest group, not bytes. Rows of
// different groups are independent and run on different warps; the rows
// of one group are a chain that one warp walks in arrival order (a batch
// without `group by` is one chain of every row). A row's cost is the
// latency of its dependent warp instructions: one warp alone on its SM has
// nothing to hide their latency behind. On an NVIDIA H100 80GB HBM3 at
// 700.00 W a row of one long chain took ~1.66 us with the first port's
// register table and takes ~0.41 us now (PERF.md); cutting branches
// gained most, fetching the next row's probe ahead (patched for this
// row's writes) lost. The design keeps each row to a short, mostly
// straight run of steps:
//
//   - small tables (H <= SMALL_MAX_H in ops/distinct.py): the table in
//     registers, lane l holding slots l, l + 32, ...; each lane finds its
//     own lowest matching and lowest empty slot with independent
//     compares, and two __reduce_min_sync give the warp's (templates up
//     to H = 256, so that chip_smoke.py can measure the crossover);
//   - large tables: the table in shared memory, 12 bytes a slot (in place
//     in the group's rows of vk/vc in global memory when it does not fit
//     beside the indices), with two indices in shared memory:
//       * a free-slot bitmap, bit s set iff count[s] <= 0, whose first 32
//         words (1,024 slots) also live in registers, one a lane: the
//         lowest free slot is one ballot, __ffs, a shuffle and __ffs,
//         found beside the probe; the table is full iff no bit is set;
//       * a hash index of the LIVE slots: open addressing with linear
//         probing over NE >= 2H 32-bit entries (16-bit tag | 16-bit slot).
//         A probe reads 32 consecutive entries, one a lane; every lane
//         loads the count and key of its entry's slot (slot 0's where the
//         tag differs, so there is no branch) and confirms (key == value
//         and count > 0), so the hash never decides a result alone; one
//         __reduce_min_sync takes the lowest confirmed slot (a carried-in
//         table may hold one value live in several slots: the reference
//         takes the lowest). A slot that dies leaves a tombstone, which a
//         later insert on its probe path reuses; the index is rebuilt from
//         the table once entries and tombstones pass 3/4 of it.
//     A row costs one probe window, one write by one lane and a
//     __syncwarp. The first port's register table walked H/32 columns
//     with up to two dependent ballots each (64 at H = 1,024) and capped H
//     at 1,024; the 16-bit slot ids of this index cap it at MAX_H (16,384);
//   - wider tables (H > MAX_H): the same design with the bitmap and an
//     index of bare 32-bit slot ids in a global-memory workspace that the
//     wrapper allocates, one slice per block, reused group after group;
//     the table works in place in vk/vc. A simple path, not yet tuned.
//
// That walk is now for groups (group by, partitions, routed shards),
// unionSet's snapshots, set inputs and the split chain's fallbacks. A
// call with one group (K == 1, so one chain holds every row of the
// batch), no snapshots, no set input and H <= SPLIT_MAX_H takes the split
// chain first, which leaves the lowest-free-slot rule only to the rows
// that change which slots are live:
//
//   - phase A, every row at once: the wrapper sorts the rows by (value,
//     arrival); an index of the carried table's live keys gives each
//     value its carried slot and count; a segmented scan of the exact
//     update c <- max(c + delta, 0) (x -> max(x + a, b) composes) gives
//     each row's count before and after, and so its class: alloc (not
//     live -> live), free (live -> dead), touch (an applying row that
//     leaves its value at 0 and still writes the lowest free slot) or
//     none; ``nd`` is the carried live count plus a prefix sum of +1 an
//     alloc and -1 a free; the events are compacted in arrival order,
//     each free naming its alloc's event or its carried slot;
//   - phase B, one warp, events only: a free-slot bitmap in shared memory,
//     walked 32 events at a time over a 32-bit mask (its kernel's comment);
//   - the commit, every slot at once: the key and count of each slot's
//     last event, the final count of carried slots no event touched, the
//     stamp.
//
// Its preconditions are checked on the card: one epoch for every row (no
// RESET inside the batch), no carried value live in two slots, no alloc
// or touch meeting a full table. Where one fails, the flag in its
// workspace makes every later split kernel and the commit return at once,
// and the walk, launched after the split chain every time, runs the call
// and counts the fallback; where none fails the walk returns at once. A
// call is one fixed launch sequence with no host read, capturable in a
// CUDA graph. No cub or thrust: the scans are written here.
//
// The wrapper (ops/distinct.py) sorts the row ids stably by group
// (torch.sort) and gathers nothing: the entry's first kernel turns the
// sorted group ids into each group's range of rows (a binary search per
// group), and the scan reads every row input through ``order``, 32 rows
// at a time, one a lane, staged in shared memory for the chain. A warp
// takes one group at a time (grid-stride); the table and the stamp are
// written back once per group, so the state is updated IN PLACE.
//
// Built at first use by siddhi_tpu_torch/ops/_cuda.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

// Laid out as ops/distinct.py's ctypes _ScanArgs.
struct ScanArgs {
  int64_t* vk;               // [K, H] value codes (updated in place)
  int32_t* vc;               // [K, H] counts: -1 never used, 0 dead
  int64_t* stamp;            // [K] epoch of the group's last applied row
  long long K;
  long long H;
  long long R;
  const int64_t* gs;         // [R] group id of each sorted position, ascending
  const int64_t* order;      // [R] original row of each sorted position
  int64_t* offsets;          // [K + 1] scratch: each group's sorted range
  const int64_t* v;          // [R] value codes (null with set_in)
  const int32_t* delta;      // [R] +1 / -1
  const uint8_t* part;       // [R] row participates
  const int64_t* ep;         // [R] absolute epoch of the row
  const int64_t* set_in;     // [R, cin] element codes, or null
  const uint8_t* set_in_m;   // [R, cin] element present, or null
  long long cin;
  int64_t* nd;               // [R] live count after each row
  int64_t* snap_vk;          // [R, H] keys after each row, or null
  uint8_t* snap_live;        // [R, H] live mask after each row, or null
  uint8_t* overflow;         // 0-d bool: set when a row found no slot
  long long path;            // PATH_REGISTERS, PATH_HASH or PATH_WIDE
  uint32_t* workspace;       // PATH_WIDE: ws_blocks slices of NW + NE words
  long long ws_blocks;       // PATH_WIDE: the grid, one slice a block
  long long split;           // 1: the split chain runs first (K == 1)
  int32_t* split_ws;         // its workspace (siddhi_distinct_split_words), or null
  const int64_t* vsorted;    // [R] value codes in (value, arrival) order
  const int64_t* vorder;     // [R] the arrival row of each of them
  unsigned long long* fallbacks;  // device count of split calls the walk finished
};

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr long long PATH_REGISTERS = 0;  // registers, H <= 32 * 8
constexpr long long PATH_HASH = 1;       // hash + bitmap, any H <= MAX_H
constexpr long long PATH_WIDE = 2;       // the same in global memory, H > MAX_H
constexpr long long MAX_H = 16384;       // slot ids are 16 bits in the hash
constexpr long long WIDE_MAX_H = 1LL << 26;  // slot << 5 | lane fits an int
constexpr int WARPS_PER_BLOCK = 4;       // register path; the hash path: 1
constexpr int MAX_BLOCKS = 8192;
constexpr uint32_t EMPTY = 0xffffffffu;  // hash entries: slot field 0xffff
constexpr uint32_t TOMB = 0xfffffffeu;   // and 0xfffe are never slots

__device__ __forceinline__ int64_t shfl64(int64_t v, int src) {
  return (int64_t)__shfl_sync(FULL, (long long)v, src);
}

// ------------------------------------------------------ small: registers

// Lane l holds slots l, l + 32, ... (C columns). ``fresh``: the table
// still reads as empty for this row; the reset is written on the first
// applied element.
template <int C>
struct RegTable {
  int64_t key[C];
  int32_t cnt[C];
  int H, lane, live;
  static constexpr bool HASHED = false;
  static constexpr bool WIDE = false;

  __device__ __forceinline__ void prehash(int64_t, uint32_t&, uint32_t&) const {}

  __device__ __forceinline__ void load(const int64_t* vk_row, const int32_t* vc_row) {
    live = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int s = c * 32 + lane;
      key[c] = s < H ? vk_row[s] : 0;
      cnt[c] = s < H ? vc_row[s] : 0;
      live += __popc(__ballot_sync(FULL, s < H && cnt[c] > 0));
    }
  }

  __device__ __forceinline__ void store(int64_t* vk_row, int32_t* vc_row) const {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int s = c * 32 + lane;
      if (s < H) {
        vk_row[s] = key[c];
        vc_row[s] = cnt[c];
      }
    }
  }

  __device__ __forceinline__ void insert(int64_t val, uint32_t, uint32_t, int32_t d, bool p,
                                         bool& fresh, bool& applied, bool& overflowed) {
    int m = INT_MAX, f = INT_MAX;
#pragma unroll
    for (int c = C - 1; c >= 0; --c) {     // descending: the lowest column wins
      const int s = c * 32 + lane;
      const bool occ = !fresh && cnt[c] > 0;
      if (s < H && occ && key[c] == val) m = s;
      if (s < H && !occ) f = s;
    }
    m = __reduce_min_sync(FULL, m);
    f = __reduce_min_sync(FULL, f);
    const bool has = m != INT_MAX;
    const int slot = has ? m : (f != INT_MAX ? f : -1);
    if (slot < 0) {               // table full: the row does not apply
      if (p) overflowed = true;
      return;
    }
    if (!p) return;
    if (fresh) {                  // materialize the lazy reset
#pragma unroll
      for (int c = 0; c < C; ++c) cnt[c] = -1;
      fresh = false;
      live = 0;
    }
    const int sc = slot >> 5;
    const int sl = slot & 31;
    int32_t newc = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c == sc && lane == sl) {
        newc = max((has ? cnt[c] : 0) + d, 0);
        cnt[c] = newc;
        key[c] = val;
      }
    }
    newc = __shfl_sync(FULL, newc, sl);
    live += (newc > 0 ? 1 : 0) - (has ? 1 : 0);
    applied = true;
  }

  __device__ __forceinline__ void snapshot(int64_t* sk, uint8_t* sl, bool fresh) const {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int s = c * 32 + lane;
      if (s < H) {
        sk[s] = key[c];
        sl[s] = (!fresh && cnt[c] > 0) ? 1 : 0;
      }
    }
  }
};

// ------------------------------------------------- large: hash + bitmap

// The warp's table (``key``/``cnt``: shared memory, or the group's rows
// in global memory), its free-slot bitmap ``bm`` [NW] and its hash index
// ``ht`` [NE], both in shared memory. Lane l also holds bitmap word l in
// ``word`` (the first 1,024 slots), so the usual free-slot search reads
// no memory. Every lane holds the same scalars.
//
// WIDE (H > MAX_H): the bitmap and the index live in a global-memory
// workspace, one slice per resident block reused group after group (at
// H = 32,768: 4 KB + 256 KB, held in the 50 MB L2), and an entry is the
// bare 32-bit slot id: no tag, since every candidate is confirmed against
// the table anyway. Everything else is the shared-memory design.
template <bool WIDE_INDEX>
struct HashTable {
  int64_t* key;
  int32_t* cnt;
  uint32_t* bm;
  uint32_t* ht;
  int H, NW, lane, shift;     // shift = 64 - log2(NE)
  uint32_t mask;              // NE - 1
  int live, fill;             // live slots; hash entries that are not EMPTY
  uint32_t word;              // bm[lane] (0 past NW)
  static constexpr bool HASHED = true;
  static constexpr bool WIDE = WIDE_INDEX;

  __device__ __forceinline__ static uint32_t entry(uint32_t tg, uint32_t s) {
    return WIDE ? s : tg << 16 | s;
  }

  __device__ __forceinline__ void prehash(int64_t v, uint32_t& h, uint32_t& tg) const {
    const uint64_t x = (uint64_t)v * 0x9E3779B97F4A7C15ull;
    h = (uint32_t)(x >> shift);
    tg = (uint32_t)(x >> (shift - 16)) & 0xffffu;
  }

  // Every live slot into a cleared index; lanes insert their own slots
  // concurrently (entries only go from EMPTY to filled, so a probe that
  // stops at the first EMPTY still finds every key).
  __device__ void rebuild() {
    for (uint32_t i = lane; i <= mask; i += 32) ht[i] = EMPTY;
    __syncwarp();
    for (int s = lane; s < H; s += 32) {
      if (cnt[s] > 0) {
        uint32_t i, tg;
        prehash(key[s], i, tg);
        const uint32_t ent = entry(tg, (uint32_t)s);
        for (;; i = (i + 1) & mask)
          if (atomicCAS(&ht[i], EMPTY, ent) == EMPTY) break;
      }
    }
    __syncwarp();
    fill = live;
  }

  // The group's stored table: the bitmap and the live count by ballots
  // over 32 slots at a time, then the index.
  __device__ void load() {
    live = 0;
#pragma unroll 4
    for (int w = 0; w < NW; ++w) {
      const int s = w * 32 + lane;
      const int32_t c = s < H ? cnt[s] : 0;
      const unsigned freeb = __ballot_sync(FULL, s < H && c <= 0);
      const unsigned liveb = __ballot_sync(FULL, s < H && c > 0);
      if (lane == 0) bm[w] = freeb;
      live += __popc(liveb);
    }
    __syncwarp();
    word = lane < NW ? bm[lane] : 0;
    rebuild();
  }

  // The lazy RESET, written: every count -1, every slot free, no entries.
  __device__ void reset() {
    for (int s = lane; s < H; s += 32) cnt[s] = -1;
    for (int w = lane; w < NW; w += 32)
      bm[w] = (w < NW - 1 || (H & 31) == 0) ? FULL : (1u << (H & 31)) - 1;
    for (uint32_t i = lane; i <= mask; i += 32) ht[i] = EMPTY;
    live = 0;
    fill = 0;
    __syncwarp();
    word = lane < NW ? bm[lane] : 0;
  }

  // The lowest free slot among words >= 32 (slots >= 1,024), -1 if none.
  __device__ int far_free() const {
    for (int w0 = 32; w0 < NW; w0 += 32) {
      const uint32_t wd = w0 + lane < NW ? bm[w0 + lane] : 0;
      const unsigned nz = __ballot_sync(FULL, wd != 0);
      if (nz) {
        const int l = __ffs(nz) - 1;
        return (w0 + l) * 32 + __ffs(__shfl_sync(FULL, wd, l)) - 1;
      }
    }
    return -1;
  }

  // One window of 32 entries from ``w0``: the lowest confirmed hit
  // (slot << 5 | lane, INT_MAX if none) and the EMPTY and TOMB ballots.
  // Every lane loads (slot 0 where its tag does not match): no branch.
  __device__ __forceinline__ void window(uint32_t w0, int64_t val, uint32_t tg, int& b,
                                         int32_t& c, unsigned& em, unsigned& tm) const {
    const uint32_t ent = ht[(w0 + lane) & mask];
    const uint32_t es = WIDE ? ent : ent & 0xffffu;
    const bool cand = WIDE ? ent < TOMB : es < 0xfffeu && (ent >> 16) == tg;
    const uint32_t ss = cand ? es : 0;
    c = cnt[ss];
    const int64_t k = key[ss];
    const bool hit = cand && c > 0 && k == val;
    b = __reduce_min_sync(FULL, hit ? (int)(es << 5 | (uint32_t)lane) : INT_MAX);
    em = __ballot_sync(FULL, ent == EMPTY);
    tm = __ballot_sync(FULL, ent == TOMB);
  }

  // ``h``/``tg``: the value's home entry and tag (prehash), computed for
  // 32 rows at once, one a lane, before the chain reaches them.
  __device__ __forceinline__ void insert(int64_t val, uint32_t h, uint32_t tg, int32_t d,
                                         bool p, bool& fresh, bool& applied,
                                         bool& overflowed) {
    // the lowest free slot among the first 1,024, found beside the probe
    const unsigned nz = __ballot_sync(FULL, word != 0);
    const int l0 = nz ? __ffs(nz) - 1 : 0;
    const int free0 = l0 * 32 + __ffs(__shfl_sync(FULL, word, l0)) - 1;
    // the probe: its first window straight through; more only when it
    // holds no EMPTY (rare below 3/4 fill)
    int best, b;
    int32_t c;
    unsigned em, tm;
    window(h, val, tg, best, c, em, tm);
    int32_t old = __shfl_sync(FULL, c, best & 31);
    uint32_t hpos = (h + (best & 31)) & mask;
    unsigned tb = tm & (em ? (em & (0u - em)) - 1 : FULL);
    uint32_t ipos = (h + __ffs(tb ? tb : em) - 1) & mask;
    bool ipos_set = (tb | em) != 0, ipos_empty = tb == 0;
    for (uint32_t w0 = h + 32; em == 0 && !fresh; w0 += 32) {
      window(w0, val, tg, b, c, em, tm);
      if (b < best) {
        best = b;
        old = __shfl_sync(FULL, c, b & 31);
        hpos = (w0 + (b & 31)) & mask;
      }
      if (!ipos_set) {
        tb = tm & (em ? (em & (0u - em)) - 1 : FULL);
        ipos = (w0 + __ffs(tb ? tb : em) - 1) & mask;
        ipos_set = (tb | em) != 0;
        ipos_empty = tb == 0;
      }
    }
    const bool has = !fresh && best != INT_MAX;
    int slot = has ? best >> 5 : fresh ? 0 : nz ? free0 : -1;
    if (slot < 0 && !fresh && NW > 32) slot = far_free();
    overflowed |= p && slot < 0;    // table full: the row does not apply
    if (!p || slot < 0) return;
    if (fresh) {                    // materialize the lazy reset
      reset();
      fresh = false;
      ipos = h;
      ipos_empty = true;
    }
    const int32_t newc = max((has ? old : 0) + d, 0);
    const bool born = !has && newc > 0;
    const bool died = has && newc == 0;
    if (lane == 0) {
      key[slot] = val;
      cnt[slot] = newc;
      if (born || died) ht[born ? ipos : hpos] = born ? entry(tg, (uint32_t)slot) : TOMB;
    }
    const int w = slot >> 5;
    if ((born || died) && lane == (w & 31)) {
      const uint32_t bit = 1u << (slot & 31);
      const uint32_t cur = w < 32 ? word : bm[w];
      const uint32_t nw = born ? cur & ~bit : cur | bit;
      bm[w] = nw;
      if (w < 32) word = nw;
    }
    live += (born ? 1 : 0) - (died ? 1 : 0);
    fill += born && ipos_empty ? 1 : 0;
    __syncwarp();
    applied = true;
    if (4 * fill > 3 * (int)(mask + 1)) rebuild();
  }

  __device__ __forceinline__ void snapshot(int64_t* sk, uint8_t* sl, bool fresh) const {
    for (int s = lane; s < H; s += 32) {
      sk[s] = key[s];
      sl[s] = (!fresh && cnt[s] > 0) ? 1 : 0;
    }
  }
};

// ---------------------------------------------------------- the chain

// Every row of one group, in arrival order, through table ``t``. SET: the
// rows are multi-element set inputs; EMIT: write the [H] snapshots. The
// warp reads 32 rows' inputs at a time, one row a lane, and stages them in
// ``stage`` (64 int4 of shared memory, two a row), from which each step
// of the chain takes its row with two broadcast loads.
template <bool SET, bool EMIT, class Table>
__device__ __forceinline__ void scan_group(const ScanArgs& a, Table& t, int4* stage,
                                           long long lo, long long hi, int64_t& st,
                                           int lane, bool& overflowed) {
  const long long H = a.H;
  for (long long base = lo; base < hi; base += 32) {
    const long long mine = base + lane;
    const bool in = mine < hi;
    const int64_t my_row = in ? a.order[mine] : 0;
    const int64_t my_v = (in && !SET) ? a.v[my_row] : 0;
    const int64_t my_e = in ? a.ep[my_row] : 0;
    uint32_t my_h = 0, my_tg = 0;
    if (Table::HASHED && !SET) t.prehash(my_v, my_h, my_tg);
    __syncwarp();                   // the last chunk's rows are read
    stage[2 * lane] = make_int4((int)(uint32_t)my_v, (int)(uint32_t)((uint64_t)my_v >> 32),
                                (int)(uint32_t)my_e, (int)(uint32_t)((uint64_t)my_e >> 32));
    // the home entry and the tag share a word; a WIDE index has no tag and
    // needs every bit of the home entry
    stage[2 * lane + 1] = make_int4((int)my_row, (int)(Table::WIDE ? my_h : my_h | my_tg << 16),
                                    in ? a.delta[my_row] : 0, in ? (int)a.part[my_row] : 0);
    __syncwarp();
    int64_t my_nd = 0;
    const int n = (int)(hi - base < 32 ? hi - base : 32);
    for (int j = 0; j < n; ++j) {
      const int4 r0 = stage[2 * j];
      const int4 r1 = stage[2 * j + 1];
      const int64_t e = (int64_t)((uint64_t)(uint32_t)r0.w << 32 | (uint32_t)r0.z);
      const int64_t row = r1.x;
      const int32_t d = r1.z;
      const bool p = r1.w != 0;
      bool fresh = st != e;
      bool applied = false;
      if (!SET) {
        const int64_t val = (int64_t)((uint64_t)(uint32_t)r0.y << 32 | (uint32_t)r0.x);
        const uint32_t hy = (uint32_t)r1.y;
        t.insert(val, Table::WIDE ? hy : hy & 0xffffu, Table::WIDE ? 0u : hy >> 16, d, p, fresh,
                 applied, overflowed);
      } else {
        for (long long c0 = 0; c0 < a.cin; c0 += 32) {
          const long long cc = c0 + lane;
          const int64_t my_el = cc < a.cin ? a.set_in[row * a.cin + cc] : 0;
          const int my_em = cc < a.cin ? (int)a.set_in_m[row * a.cin + cc] : 0;
          const int m = (int)(a.cin - c0 < 32 ? a.cin - c0 : 32);
          uint32_t el_h = 0, el_tg = 0;
          if (Table::HASHED) t.prehash(my_el, el_h, el_tg);
          for (int k = 0; k < m; ++k) {
            const bool pe = p && __shfl_sync(FULL, my_em, k) != 0;
            const uint32_t h = Table::HASHED ? __shfl_sync(FULL, el_h, k) : 0;
            const uint32_t tg = Table::HASHED ? __shfl_sync(FULL, el_tg, k) : 0;
            t.insert(shfl64(my_el, k), h, tg, d, pe, fresh, applied, overflowed);
          }
        }
      }
      if (applied) st = e;
      if (lane == j) my_nd = fresh ? 0 : t.live;
      if (EMIT) t.snapshot(a.snap_vk + row * H, a.snap_live + row * H, fresh);
    }
    if (in) a.nd[my_row] = my_nd;
  }
}

// ------------------------------------------------- the split chain (K == 1)

// The workspace of the split chain, in int32 words. ``ident`` (the walk's
// row order, the identity, 2R words) comes first, so that the wrapper
// hands its address to the walk as ``order``; the words from ``ctl`` to
// ``slot_final`` are zeroed by one memset a call.
struct SplitLayout {
  long long ident, ctl, hidx, last_ev, slot_final, ev_val;   // ev_val: int64
  long long elem, out, flags;                                // elem, out: int4
  long long cls, ref, fin, evidx, ev_type, ev_ref, ev_cnt, ev_slot, words;
  long long zero_from, zero_words;
  int log_ne;
};

constexpr long long SPLIT_MAX_H = 32 * 32 * 32;  // the bitmap: a summary word a lane
constexpr int CTL_FAIL = 0, CTL_LIVE0 = 1, CTL_EVENTS = 2, CTL_FRESH = 3, CTL_WORDS = 8;
constexpr int EV_NONE = 0, EV_ALLOC = 1, EV_FREE = 2, EV_TOUCH = 3;
constexpr int SCAN_THREADS = 1024, SCAN_ITEMS = 4, SCAN_CHUNK = SCAN_THREADS * SCAN_ITEMS;
constexpr int NEG_A = -(1 << 30);                // "minus infinity" of a count offset

__host__ __device__ inline SplitLayout split_layout(long long H, long long R) {
  SplitLayout L;
  L.log_ne = 5;                                  // NE = 2^log_ne >= 2H, >= 32
  while ((1LL << L.log_ne) < 2 * H) ++L.log_ne;
  L.ident = 0;
  L.ctl = 2 * R;
  L.hidx = L.ctl + CTL_WORDS;
  L.last_ev = L.hidx + (1LL << L.log_ne);
  L.slot_final = L.last_ev + H;
  L.ev_val = L.slot_final + H;
  L.ev_val += L.ev_val & 1;                      // 8-byte aligned
  L.elem = L.ev_val + 2 * R;
  L.elem += (4 - (L.elem & 3)) & 3;              // 16-byte aligned
  L.out = L.elem + 4 * R;
  L.flags = L.out + 4 * R;
  L.cls = L.flags + R;
  L.ref = L.cls + R;
  L.fin = L.ref + R;
  L.evidx = L.fin + R;
  L.ev_type = L.evidx + R;
  L.ev_ref = L.ev_type + R;
  L.ev_cnt = L.ev_ref + R;
  L.ev_slot = L.ev_cnt + R;
  L.words = L.ev_slot + R;
  L.zero_from = L.ctl;
  L.zero_words = L.ev_val - L.ctl;
  return L;
}

// The walk after the split chain: returns at once where the chain finished
// the call; where it fell back, the walk runs and counts the fallback.
__device__ __forceinline__ bool split_done(const ScanArgs& a) {
  if (a.split_ws == nullptr) return false;
  if (a.split_ws[2 * a.R + CTL_FAIL] == 0) return true;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(a.fallbacks, 1ull);
  return false;
}

__device__ __forceinline__ uint32_t home(int64_t v, int log_ne) {
  return (uint32_t)(((uint64_t)v * 0x9E3779B97F4A7C15ull) >> (64 - log_ne));
}

// x -> max(x + A, B) on counts x >= 0: the exact update c <- max(c + d, 0)
// of an applying row is (d, 0), a row that does not apply (0, 0), and a
// value's first row (its carried count c0 folded in) the constant
// (NEG_A, its count after); the composition of two such maps is one.
// ``h``/``cs``: the segment's first row and its carried slot, copied along.
struct CountMap {
  int A, B, h, cs;
};
__device__ __forceinline__ CountMap combine(const CountMap& x, const CountMap& y) {
  return {max(x.A + y.A, NEG_A), max(x.B + y.A, y.B), x.h | y.h, y.h ? y.cs : x.cs};
}
__device__ __forceinline__ CountMap shfl_up(const CountMap& x, int d) {
  return {__shfl_up_sync(FULL, x.A, d), __shfl_up_sync(FULL, x.B, d),
          __shfl_up_sync(FULL, x.h, d), __shfl_up_sync(FULL, x.cs, d)};
}

// Segmented by value: the last alloc row so far (L) and whether the
// segment has had an event (E).
struct LastAlloc {
  int h, L, E;
};
__device__ __forceinline__ LastAlloc combine(const LastAlloc& x, const LastAlloc& y) {
  return {x.h | y.h, y.h ? y.L : max(x.L, y.L), y.h ? y.E : (x.E | y.E)};
}
__device__ __forceinline__ LastAlloc shfl_up(const LastAlloc& x, int d) {
  return {__shfl_up_sync(FULL, x.h, d), __shfl_up_sync(FULL, x.L, d),
          __shfl_up_sync(FULL, x.E, d)};
}

// In arrival order: the change of the live count (dl) and the events (ne).
struct RowSums {
  int dl, ne;
};
__device__ __forceinline__ RowSums combine(const RowSums& x, const RowSums& y) {
  return {x.dl + y.dl, x.ne + y.ne};
}
__device__ __forceinline__ RowSums shfl_up(const RowSums& x, int d) {
  return {__shfl_up_sync(FULL, x.dl, d), __shfl_up_sync(FULL, x.ne, d)};
}

// The exclusive prefix of ``v`` over the block's threads in order, and the
// block's total. ``sh``: 32 entries of shared memory.
template <class T>
__device__ __forceinline__ T block_exclusive(T v, T ident, T* sh, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  T x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = shfl_up(x, d);
    if (lane >= d) x = combine(y, x);
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nw ? sh[lane] : ident;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = shfl_up(w, d);
      if (lane >= d) w = combine(y, w);
    }
    sh[lane] = w;
  }
  __syncthreads();
  T ex = shfl_up(x, 1);
  if (lane == 0) ex = ident;
  if (warp > 0) ex = combine(sh[warp - 1], ex);
  total = sh[nw - 1];
  __syncthreads();
  return ex;
}

// Phase A, 1: the identity row order for the walk, and an index of the
// carried table's live slots (open addressing over slot + 1, 0 empty) with
// their number. A fresh epoch reads the table as empty: no entries.
__global__ void distinct_scan_split_index(const ScanArgs a, const SplitLayout L) {
  int32_t* ws = a.split_ws;
  const bool fresh = a.stamp[0] != a.ep[0];
  int64_t* ident = reinterpret_cast<int64_t*>(ws + L.ident);
  int32_t* hidx = ws + L.hidx;
  const uint32_t mask = (1u << L.log_ne) - 1;
  const long long n = a.R > a.H ? a.R : a.H;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n; base += stride) {
    const long long i = base + threadIdx.x;
    if (i < a.R) ident[i] = i;
    const bool live = i < a.H && !fresh && a.vc[i] > 0;
    const unsigned b = __ballot_sync(FULL, live);
    if ((threadIdx.x & 31) == 0 && b) atomicAdd(&ws[L.ctl + CTL_LIVE0], __popc(b));
    if (live) {
      for (uint32_t h = home(a.vk[i], L.log_ne);; h = (h + 1) & mask)
        if (atomicCAS(&hidx[h], 0, (int)i + 1) == 0) break;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) ws[L.ctl + CTL_FRESH] = fresh ? 1 : 0;
}

// Phase A, 2 (every row at once, in (value, arrival) order): each row's
// count map (``elem``: its x, its value's carried count c0 and slot cs at
// the value's first row, its arrival row) and flags (first row of its
// value, last, participates). A value's carried slot is the lowest live
// slot holding it; two such slots fail the chain, as do rows of another
// epoch than the first.
__global__ void distinct_scan_split_lookup(const ScanArgs a, const SplitLayout L) {
  int32_t* ws = a.split_ws;
  const int32_t* hidx = ws + L.hidx;
  int4* elem = reinterpret_cast<int4*>(ws + L.elem);
  const uint32_t mask = (1u << L.log_ne) - 1;
  const long long R = a.R;
  const int64_t ep0 = a.ep[0];
  bool bad = false;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < R; i += stride) {
    const int64_t v = a.vsorted[i];
    const int r = (int)a.vorder[i];
    const bool head = i == 0 || a.vsorted[i - 1] != v;
    const bool tail = i == R - 1 || a.vsorted[i + 1] != v;
    const int d = a.delta[r];
    const bool p = a.part[r] != 0;
    bad |= a.ep[r] != ep0;
    int cs = -1, c0 = 0, x = p ? d : 0;
    if (head) {
      int hits = 0;
      for (uint32_t h = home(v, L.log_ne);; h = (h + 1) & mask) {
        const int ent = hidx[h];
        if (ent == 0) break;
        if (a.vk[ent - 1] == v) {
          ++hits;
          if (cs < 0 || ent - 1 < cs) cs = ent - 1;
        }
      }
      bad |= hits > 1;
      c0 = cs >= 0 ? a.vc[cs] : 0;
      x = p ? max(c0 + d, 0) : c0;
    }
    elem[i] = make_int4(x, c0, cs, r);
    ws[L.flags + i] = (head ? 1 : 0) | (tail ? 2 : 0) | (p ? 4 : 0);
  }
  if (bad) ws[L.ctl + CTL_FAIL] = 1;
}

// Phase A, 3 (one block, in (value, arrival) order): the count before and
// after every row by a scan of CountMap (a value's first row is the
// constant map to its count after), each row's class, each free's
// partner (the value's last alloc row, else -(carried slot + 1)), and at
// each value's last row what the scatter pass writes, all into ``out`` by
// sorted position (coalesced).
__global__ void __launch_bounds__(SCAN_THREADS) distinct_scan_split_values(const ScanArgs a,
                                                                          const SplitLayout L) {
  int32_t* ws = a.split_ws;
  if (ws[L.ctl + CTL_FAIL]) return;
  const int4* elem = reinterpret_cast<const int4*>(ws + L.elem);
  int4* out = reinterpret_cast<int4*>(ws + L.out);
  const long long R = a.R;
  __shared__ CountMap sh1[32];
  __shared__ LastAlloc sh2[32];
  const CountMap id1 = {0, 0, 0, -1};
  const LastAlloc id2 = {0, -1, 0};
  CountMap carry1 = id1;
  LastAlloc carry2 = id2;
  for (long long c0 = 0; c0 < R; c0 += SCAN_CHUNK) {
    CountMap e1[SCAN_ITEMS];
    int row[SCAN_ITEMS], cnt0[SCAN_ITEMS], flags[SCAN_ITEMS];
    CountMap agg1 = id1;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      const long long i = c0 + (long long)threadIdx.x * SCAN_ITEMS + k;
      e1[k] = id1;
      row[k] = -1;
      cnt0[k] = 0;
      flags[k] = 0;
      if (i < R) {
        const int4 q = elem[i];
        flags[k] = ws[L.flags + i];
        row[k] = q.w;
        cnt0[k] = q.y;
        e1[k] = flags[k] & 1 ? CountMap{NEG_A, q.x, 1, q.z} : CountMap{q.x, 0, 0, -1};
      }
      agg1 = combine(agg1, e1[k]);
    }
    CountMap tot1;
    CountMap pre1 = combine(carry1, block_exclusive(agg1, id1, sh1, tot1));
    carry1 = combine(carry1, tot1);
    int cls[SCAN_ITEMS], after[SCAN_ITEMS], seg_cs[SCAN_ITEMS];
    LastAlloc e2[SCAN_ITEMS];
    LastAlloc agg2 = id2;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      const CountMap inc = combine(pre1, e1[k]);
      const bool head = flags[k] & 1, part = flags[k] & 4;
      const int before = head ? cnt0[k] : pre1.B;
      after[k] = inc.B;
      seg_cs[k] = inc.cs;
      pre1 = inc;
      const bool lb = before > 0, la = after[k] > 0;
      cls[k] = !part ? EV_NONE
               : (!lb && la) ? EV_ALLOC
               : (lb && !la) ? EV_FREE
               : (!lb && !la) ? EV_TOUCH : EV_NONE;
      e2[k] = row[k] < 0 ? id2 : LastAlloc{head ? 1 : 0, cls[k] == EV_ALLOC ? row[k] : -1,
                                             cls[k] != EV_NONE ? 1 : 0};
      agg2 = combine(agg2, e2[k]);
    }
    LastAlloc tot2;
    LastAlloc pre2 = combine(carry2, block_exclusive(agg2, id2, sh2, tot2));
    carry2 = combine(carry2, tot2);
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      const long long i = c0 + (long long)threadIdx.x * SCAN_ITEMS + k;
      const LastAlloc inc = combine(pre2, e2[k]);
      if (i < R) {
        // x: the class, 4 a carried slot no event touched, 8 a last alloc
        // that lasts (both at the value's last row); y: a free's partner
        // (its alloc row, else -(carried slot + 1)), else the carried slot
        const bool tail = flags[k] & 2;
        const int partner = flags[k] & 1 ? -1 : pre2.L;
        const int x = cls[k] | (tail && seg_cs[k] >= 0 && !inc.E ? 4 : 0) |
                      (tail && inc.L >= 0 && after[k] > 0 ? 8 : 0);
        const int y = cls[k] != EV_FREE ? seg_cs[k] : partner >= 0 ? partner : -(seg_cs[k] + 1);
        out[i] = make_int4(x, y, inc.L, after[k]);
      }
      pre2 = inc;
    }
  }
}

// Phase A, 3b (every row at once): the value pass's results by arrival
// row (class, partner), and the final counts of lasting allocs (``fin``,
// by row) and of carried slots no event touched (``slot_final``).
__global__ void distinct_scan_split_scatter(const ScanArgs a, const SplitLayout L) {
  int32_t* ws = a.split_ws;
  if (ws[L.ctl + CTL_FAIL]) return;
  const int4* elem = reinterpret_cast<const int4*>(ws + L.elem);
  const int4* out = reinterpret_cast<const int4*>(ws + L.out);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < a.R; i += stride) {
    const int4 q = out[i];
    const int row = elem[i].w, c = q.x & 3;
    ws[L.cls + row] = c;
    if (c == EV_FREE) ws[L.ref + row] = q.y;
    if (q.x & 4) ws[L.slot_final + q.y] = q.w;
    if (q.x & 8) ws[L.fin + q.z] = q.w;
  }
}

// Phase A, 4 (one block, in arrival order): ``nd`` = the carried live
// count plus +1 an alloc and -1 a free so far, each event's index, their
// number; an alloc or touch that meets a full table fails the chain (the
// walk overflows there).
__global__ void __launch_bounds__(SCAN_THREADS) distinct_scan_split_rows(const ScanArgs a,
                                                                        const SplitLayout L) {
  int32_t* ws = a.split_ws;
  if (ws[L.ctl + CTL_FAIL]) return;
  const int32_t* cls_of = ws + L.cls;
  int32_t* evidx = ws + L.evidx;
  const int live0 = ws[L.ctl + CTL_LIVE0];
  const long long R = a.R;
  __shared__ RowSums sh[32];
  const RowSums id = {0, 0};
  RowSums carry = id;
  bool bad = false;
  for (long long c0 = 0; c0 < R; c0 += SCAN_CHUNK) {
    int cls[SCAN_ITEMS];
    RowSums e[SCAN_ITEMS];
    RowSums agg = id;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      const long long i = c0 + (long long)threadIdx.x * SCAN_ITEMS + k;
      cls[k] = i < R ? cls_of[i] : EV_NONE;
      e[k] = {cls[k] == EV_ALLOC ? 1 : cls[k] == EV_FREE ? -1 : 0, cls[k] != EV_NONE ? 1 : 0};
      agg = combine(agg, e[k]);
    }
    RowSums tot;
    RowSums pre = combine(carry, block_exclusive(agg, id, sh, tot));
    carry = combine(carry, tot);
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      const long long i = c0 + (long long)threadIdx.x * SCAN_ITEMS + k;
      if (i < R) {
        const int live = live0 + pre.dl;
        bad |= (cls[k] == EV_ALLOC || cls[k] == EV_TOUCH) && live >= a.H;
        a.nd[i] = live + e[k].dl;
        if (cls[k] != EV_NONE) evidx[i] = pre.ne;
      }
      pre = combine(pre, e[k]);
    }
  }
  if (threadIdx.x == 0) ws[L.ctl + CTL_EVENTS] = carry.ne;
  if (bad) ws[L.ctl + CTL_FAIL] = 1;
}

// Phase A, 5: the events compacted in arrival order; a free's partner
// becomes the event index of its alloc (or stays -(carried slot + 1)).
__global__ void distinct_scan_split_events(const ScanArgs a, const SplitLayout L) {
  int32_t* ws = a.split_ws;
  if (ws[L.ctl + CTL_FAIL]) return;
  const int32_t* cls_of = ws + L.cls;
  const int32_t* ref_of = ws + L.ref;
  const int32_t* evidx = ws + L.evidx;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < a.R; r += stride) {
    const int c = cls_of[r];
    if (c == EV_NONE) continue;
    const int e = evidx[r];
    ws[L.ev_type + e] = c;
    reinterpret_cast<int64_t*>(ws + L.ev_val)[e] = a.v[r];
    ws[L.ev_cnt + e] = c == EV_ALLOC ? ws[L.fin + r] : 0;
    int ref = 0;
    if (c == EV_FREE) {
      ref = ref_of[r];
      if (ref >= 0) ref = evidx[ref];
    }
    ws[L.ev_ref + e] = ref;
  }
}

// The inclusive sum of ``x`` over the warp's lanes up to this one.
__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// The first word at or after word ``p`` with a free slot, from the summary
// (``summ``: this lane's summary word, bit j of lane l's word set iff word
// 32 l + j has one), or ``nw`` if none.
__device__ __forceinline__ int first_free_word(uint32_t summ, int p, int lane, int nw) {
  const int lo = p - lane * 32;
  const uint32_t m = lo <= 0 ? summ : lo >= 32 ? 0u : summ & (FULL << lo);
  const unsigned b = __ballot_sync(FULL, m != 0);
  if (!b) return nw;
  const int l = __ffs(b) - 1;
  return l * 32 + __ffs(__shfl_sync(FULL, m, l)) - 1;
}

// The position of the k-th (from 0) set bit of ``x``, which has more
// than k: a binary search on popcounts of halves.
__device__ __forceinline__ int nth_bit(uint32_t x, int k) {
  int pos = 0;
#pragma unroll
  for (int width = 16; width; width >>= 1) {
    const int c = __popc(x & ((1u << width) - 1));
    const bool up = k >= c;
    k -= up ? c : 0;
    x >>= up ? width : 0;
    pos += up ? width : 0;
  }
  return pos;
}

// Phase B (one warp, events only): the free-slot bitmap (bit s set iff
// count[s] <= 0) in shared memory with a summary of its non-empty words,
// walked 32 events at a time, one a lane. Within a chunk every alloc or
// touch takes or reads the lowest free slot, which lies in U = Q + X: Q
// the m lowest free slots at the chunk's start (m its allocs and touches:
// the allocs before any one of them take at most m - 1 of Q, always its
// lowest), X the slots its frees release whose alloc came in an earlier
// chunk or before the batch (an inner free releases a slot that an alloc
// of the chunk took, from U). |Q| + |X| <= 32, so U ranked by slot is one
// 32-bit mask ``A`` of free members, and the chunk's walk is a bit trick a
// step: an alloc A &= A - 1 (its slot the lowest bit before), a free
// A |= its bit, a touch reads the lowest bit. Then Q's taken slots leave
// the bitmap and X's slots still free join it. A free's slot: its alloc's
// lane of this chunk (a shuffle of the rank), of the last chunk (a
// shuffle of its slot), older (``ev_slot``, loaded a chunk ahead), or the
// carried slot. Each chunk's slots go to ``ev_slot``, and each slot's
// last event so far to ``last_ev`` (an atomicMax of event index + 1).
__global__ void __launch_bounds__(32) distinct_scan_split_walk(const ScanArgs a,
                                                               const SplitLayout L) {
  __shared__ uint32_t free_bits[SPLIT_MAX_H / 32];
  __shared__ uint32_t summary[32];
  __shared__ int ubuf[32];
  int32_t* ws = a.split_ws;
  if (ws[L.ctl + CTL_FAIL]) return;
  const int n = ws[L.ctl + CTL_EVENTS];
  const bool fresh = ws[L.ctl + CTL_FRESH] != 0;
  const int lane = threadIdx.x;
  const int H = (int)a.H;
  const int nw = (H + 31) >> 5;
  const int32_t* ev_type = ws + L.ev_type;
  const int32_t* ev_ref = ws + L.ev_ref;
  int32_t* ev_slot = ws + L.ev_slot;
  int32_t* last_ev = ws + L.last_ev;
  for (int w0 = 0; w0 < nw; w0 += 32) {       // word w0 + j: slots 32 (w0 + j) + lane
    uint32_t mine = 0;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int s = (w0 + j) * 32 + lane;
      const unsigned b = __ballot_sync(FULL, s < H && (fresh || a.vc[s] <= 0));
      mine = lane == j ? b : mine;
    }
    if (w0 + lane < nw) free_bits[w0 + lane] = mine;
    const unsigned nz = __ballot_sync(FULL, mine != 0);
    if (lane == 0) summary[w0 >> 5] = nz;
  }
  if (lane >= (nw + 31) >> 5) summary[lane] = 0;
  __syncwarp();
  int tA = lane < n ? ev_type[lane] : EV_NONE, rA = lane < n ? ev_ref[lane] : 0;
  int tB = 32 + lane < n ? ev_type[32 + lane] : EV_NONE;
  int rB = 32 + lane < n ? ev_ref[32 + lane] : 0;
  int gA = 0, prev_slot = 0;
  for (int base = 0; base < n; base += 32) {
    const int e2 = base + 64 + lane;
    const int tC = e2 < n ? ev_type[e2] : EV_NONE, rC = e2 < n ? ev_ref[e2] : 0;
    // the next chunk's partners in chunks before this one: stored already
    const int gB = tB == EV_FREE && rB >= 0 && rB < base ? ev_slot[rB] : 0;
    const int rel = rA - base;
    const bool inner = tA == EV_FREE && rA >= 0 && rel >= 0;
    const bool known = tA == EV_FREE && !inner;
    const int from_prev = __shfl_sync(FULL, prev_slot, rel & 31);
    const int x = !known ? INT_MAX : rA < 0 ? -rA - 1 : rel >= -32 ? from_prev : gA;
    const int m = __popc(__ballot_sync(FULL, tA == EV_ALLOC || tA == EV_TOUCH));
    // Q: the m lowest free slots, from windows of 128 consecutive words
    // (four a lane, in order) from the first word with a free slot: one
    // window unless free slots are sparse. Lane i takes Q's i-th member:
    // the lane that holds it by a binary search on the counts' prefix,
    // then the bit within that lane's words
    int q = INT_MAX;
    if (m) {
      const uint32_t summ = summary[lane];
      int have = 0;
      for (int w = first_free_word(summ, 0, lane, nw); w < nw;
           w = first_free_word(summ, w + 128, lane, nw)) {
        const int w4 = w + 4 * lane;
        uint32_t bits[4];
        int c = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          bits[k] = w4 + k < nw ? free_bits[w4 + k] : 0u;
          c += __popc(bits[k]);
        }
        const int incl = warp_inclusive_sum(c, lane);
        const int total = __shfl_sync(FULL, incl, 31);
        const int want = lane - have;            // the rank within this window
        int owner = 0;                           // lanes whose prefix is <= want
#pragma unroll
        for (int step = 16; step; step >>= 1)
          owner += __shfl_sync(FULL, incl, owner + step - 1) <= want ? step : 0;
        int k = want - __shfl_sync(FULL, incl - c, owner);
        uint32_t word = 0u;
        int j = -1;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t o = __shfl_sync(FULL, bits[i], owner);
          const int p = __popc(o);
          const bool here = j < 0 && k < p;
          word = here ? o : word;
          j = here ? i : j;
          k -= j < 0 ? p : 0;
        }
        if (lane < m && want >= 0 && want < total)
          q = (w + 4 * owner + j) * 32 + nth_bit(word, k);
        have += total;
        if (have >= m) break;
      }
    }
    // U = Q + X by slot: Q's rank is its lane plus the X below it; X's the
    // Q below it (a binary search over Q's lanes, which hold it sorted)
    // plus the X below it (the members are distinct: Q free, X live)
    const unsigned xs = __ballot_sync(FULL, known);
    int rx = 0, below = 0;
    if (xs) {
#pragma unroll
      for (int step = 16; step; step >>= 1)
        rx += __shfl_sync(FULL, q, rx + step - 1) < x ? step : 0;
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int xt = __shfl_sync(FULL, x, t);
        rx += xt < x;
        below += xt < q;
      }
    }
    const int rq = lane + below;
    const bool hasq = q != INT_MAX;
    uint32_t A = __reduce_or_sync(FULL, hasq ? 1u << rq : 0u);
    if (hasq) ubuf[rq] = q;
    if (known) ubuf[rx] = x;
    __syncwarp();
    // the chunk's walk, every step uniform. Without an inner free each step
    // is two operations on A: (A & (A - alloc)) | the free's bit, with
    // every step's inputs independent of A; an inner free takes its
    // alloc's rank from that lane, one shuffle on the chain
    const unsigned allocs = __ballot_sync(FULL, tA == EV_ALLOC);
    int mine = 0;
    if (!__ballot_sync(FULL, inner)) {
      const uint32_t fbit = known ? 1u << rx : 0u;
      uint32_t my = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const uint32_t f = __shfl_sync(FULL, fbit, j);
        const uint32_t take = A & (0u - A);
        my = lane == j ? (f ? f : take) : my;
        A = (A & (A - (allocs >> j & 1u))) | f;
      }
      mine = __ffs(my) - 1;
    } else {
      const int arg = known ? rx : inner ? 32 + rel : 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int tj = __shfl_sync(FULL, tA, j);
        int fi = __shfl_sync(FULL, arg, j);
        if (fi >= 32) fi = __shfl_sync(FULL, mine, fi - 32);
        const int low = __ffs(A) - 1;
        A = tj == EV_ALLOC ? A & (A - 1) : tj == EV_FREE ? A | 1u << fi : A;
        mine = lane == j ? (tj == EV_FREE ? fi : low) : mine;
      }
    }
    const int slot = ubuf[mine & 31];
    // the bitmap: Q's slots that were taken leave it, X's still free join
    int wq = -1, wx = -1;
    if (hasq && !(A >> rq & 1)) {
      wq = q >> 5;
      atomicAnd(&free_bits[wq], ~(1u << (q & 31)));
    }
    if (known && (A >> rx & 1)) {
      wx = x >> 5;
      atomicOr(&free_bits[wx], 1u << (x & 31));
    }
    __syncwarp();
    if (wq >= 0 && free_bits[wq] == 0) atomicAnd(&summary[wq >> 5], ~(1u << (wq & 31)));
    if (wx >= 0) atomicOr(&summary[wx >> 5], 1u << (wx & 31));
    const int cnt = n - base < 32 ? n - base : 32;
    if (lane < cnt) ev_slot[base + lane] = slot;
    if (lane < cnt) atomicMax(&last_ev[slot], base + lane + 1);
    __syncwarp();
    prev_slot = slot;
    tA = tB;
    rA = rB;
    gA = gB;
    tB = tC;
    rB = rC;
  }
}

// The commit: each slot's last event writes its key and count (an alloc
// that lasts to the end the value's final count, a free or touch 0); a
// carried slot no event touched takes its value's final count; in a fresh
// epoch with any applied row every other slot reads -1 (the RESET
// written) and the stamp moves. Nothing when the chain failed.
__global__ void distinct_scan_split_commit(const ScanArgs a, const SplitLayout L) {
  const int32_t* ws = a.split_ws;
  if (ws[L.ctl + CTL_FAIL]) return;
  const bool reset = ws[L.ctl + CTL_FRESH] != 0 && ws[L.ctl + CTL_EVENTS] > 0;
  const int64_t* ev_val = reinterpret_cast<const int64_t*>(ws + L.ev_val);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < a.H; s += stride) {
    const int le = ws[L.last_ev + s];
    const int sf = ws[L.slot_final + s];
    if (le) {
      a.vk[s] = ev_val[le - 1];
      a.vc[s] = ws[L.ev_cnt + le - 1];
    } else if (sf) {
      a.vc[s] = sf;
    } else if (reset) {
      a.vc[s] = -1;
    }
  }
  if (reset && blockIdx.x == 0 && threadIdx.x == 0) a.stamp[0] = a.ep[0];
}

int launch_split(const ScanArgs& a, cudaStream_t s) {
  const SplitLayout L = split_layout(a.H, a.R);
  const cudaError_t e =
      cudaMemsetAsync(a.split_ws + L.zero_from, 0, 4 * (size_t)L.zero_words, s);
  if (e != cudaSuccess) return (int)e;
  const long long n = a.R > a.H ? a.R : a.H;
  const long long g0 = (n + 255) / 256, gr = (a.R + 255) / 256, gh = (a.H + 255) / 256;
  distinct_scan_split_index<<<(unsigned)(g0 < 1024 ? g0 : 1024), 256, 0, s>>>(a, L);
  distinct_scan_split_lookup<<<(unsigned)(gr < 1024 ? gr : 1024), 256, 0, s>>>(a, L);
  distinct_scan_split_values<<<1, SCAN_THREADS, 0, s>>>(a, L);
  distinct_scan_split_scatter<<<(unsigned)(gr < 1024 ? gr : 1024), 256, 0, s>>>(a, L);
  distinct_scan_split_rows<<<1, SCAN_THREADS, 0, s>>>(a, L);
  distinct_scan_split_events<<<(unsigned)(gr < 1024 ? gr : 1024), 256, 0, s>>>(a, L);
  distinct_scan_split_walk<<<1, 32, 0, s>>>(a, L);
  distinct_scan_split_commit<<<(unsigned)(gh < 1024 ? gh : 1024), 256, 0, s>>>(a, L);
  return 0;
}

// offsets[g] = the first sorted position whose group is >= g, for each
// g <= K (a binary search each, so groups without rows cost nothing
// extra); also clears the overflow flag before the scan runs.
__global__ void distinct_scan_offsets(const ScanArgs a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g <= a.K;
       g += stride) {
    long long lo = 0, hi = a.R;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (a.gs[mid] < g) lo = mid + 1;
      else hi = mid;
    }
    a.offsets[g] = lo;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.overflow = 0;
}

template <int C, bool SET, bool EMIT>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
distinct_scan_registers(const ScanArgs a) {
  if (split_done(a)) return;
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  __shared__ int4 stage[WARPS_PER_BLOCK][64];
  RegTable<C> t;
  t.H = (int)a.H;
  t.lane = lane;
  bool overflowed = false;
  for (long long g = warp; g < a.K; g += n_warps) {
    const long long lo = a.offsets[g];
    const long long hi = a.offsets[g + 1];
    if (lo >= hi) continue;
    t.load(a.vk + g * a.H, a.vc + g * a.H);
    int64_t st = a.stamp[g];
    scan_group<SET, EMIT>(a, t, stage[threadIdx.x >> 5], lo, hi, st, lane, overflowed);
    t.store(a.vk + g * a.H, a.vc + g * a.H);
    if (lane == 0) a.stamp[g] = st;
  }
  if (overflowed && lane == 0) *a.overflow = 1;
}

// One warp a block. SHARED: the table lives in shared memory, copied in
// and out once per group; otherwise the warp works in place on the
// group's rows of vk/vc in global memory (they stay in L1/L2). WIDE: the
// bitmap and the index too, in the block's slice of the workspace.
template <bool SHARED, bool WIDE, bool SET, bool EMIT>
__global__ void __launch_bounds__(32) distinct_scan_hash(const ScanArgs a, int log_ne) {
  if (split_done(a)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int H = (int)a.H;
  HashTable<WIDE> t;
  t.H = H;
  t.NW = (H + 31) >> 5;
  t.lane = lane;
  t.shift = 64 - log_ne;
  t.mask = (1u << log_ne) - 1;
  int4* stage = reinterpret_cast<int4*>(smem);
  int64_t* skey = reinterpret_cast<int64_t*>(stage + 64);
  int32_t* scnt = reinterpret_cast<int32_t*>(skey + (SHARED ? H : 0));
  t.bm = WIDE ? a.workspace + blockIdx.x * ((size_t)t.NW + ((size_t)1 << log_ne))
              : reinterpret_cast<uint32_t*>(scnt + (SHARED ? H : 0));
  t.ht = t.bm + t.NW;
  bool overflowed = false;
  for (long long g = blockIdx.x; g < a.K; g += gridDim.x) {
    const long long lo = a.offsets[g];
    const long long hi = a.offsets[g + 1];
    if (lo >= hi) continue;
    int64_t* vk_row = a.vk + g * H;
    int32_t* vc_row = a.vc + g * H;
    __syncwarp();
    if (SHARED) {
      for (int s = lane; s < H; s += 32) {
        skey[s] = vk_row[s];
        scnt[s] = vc_row[s];
      }
      t.key = skey;
      t.cnt = scnt;
      __syncwarp();
    } else {
      t.key = vk_row;
      t.cnt = vc_row;
    }
    t.load();
    int64_t st = a.stamp[g];
    scan_group<SET, EMIT>(a, t, stage, lo, hi, st, lane, overflowed);
    if (SHARED) {
      __syncwarp();
      for (int s = lane; s < H; s += 32) {
        vk_row[s] = skey[s];
        vc_row[s] = scnt[s];
      }
    }
    if (lane == 0) a.stamp[g] = st;
  }
  if (overflowed && lane == 0) *a.overflow = 1;
}

template <bool SET, bool EMIT>
void launch_registers(const ScanArgs& a, dim3 grid, cudaStream_t s) {
  const dim3 block(WARPS_PER_BLOCK * 32);
  const long long cols = (a.H + 31) / 32;
  if (cols <= 1) distinct_scan_registers<1, SET, EMIT><<<grid, block, 0, s>>>(a);
  else if (cols <= 2) distinct_scan_registers<2, SET, EMIT><<<grid, block, 0, s>>>(a);
  else if (cols <= 4) distinct_scan_registers<4, SET, EMIT><<<grid, block, 0, s>>>(a);
  else distinct_scan_registers<8, SET, EMIT><<<grid, block, 0, s>>>(a);
}

template <bool SHARED, bool WIDE, bool SET, bool EMIT>
int launch_hash(const ScanArgs& a, int log_ne, size_t smem, long long blocks, cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      distinct_scan_hash<SHARED, WIDE, SET, EMIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)blocks), block(32);
  distinct_scan_hash<SHARED, WIDE, SET, EMIT><<<grid, block, smem, s>>>(a, log_ne);
  return 0;
}

template <bool SET, bool EMIT>
int launch(const ScanArgs& a, cudaStream_t s) {
  if (a.path == PATH_HASH || a.path == PATH_WIDE) {
    int log_ne = 5;                          // NE = 2^log_ne >= 2H, >= 32
    while ((1LL << log_ne) < 2 * a.H) ++log_ne;
    if (a.path == PATH_WIDE)                 // only the row stage is shared
      return launch_hash<false, true, SET, EMIT>(a, log_ne, 1024, a.ws_blocks, s);
    const long long blocks = a.K < MAX_BLOCKS ? a.K : MAX_BLOCKS;
    // the row stage, the bitmap and the index; the table beside them if it fits
    const size_t index = 1024 + 4 * (size_t)((a.H + 31) / 32) + 4 * ((size_t)1 << log_ne);
    const size_t table = 12 * (size_t)a.H;
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (index + table <= (size_t)optin)
      return launch_hash<true, false, SET, EMIT>(a, log_ne, index + table, blocks, s);
    return launch_hash<false, false, SET, EMIT>(a, log_ne, index, blocks, s);
  }
  long long blocks = (a.K + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const dim3 grid((unsigned)blocks);
  launch_registers<SET, EMIT>(a, grid, s);
  return 0;
}

}  // namespace

extern "C" int siddhi_distinct_scan(const ScanArgs* args, void* stream) {
  const ScanArgs a = *args;
  if (a.K < 1 || a.H < 1 || a.R < 1 || a.R > INT_MAX || a.cin < 0)
    return (int)cudaErrorInvalidValue;
  const bool ok = a.path == PATH_REGISTERS ? a.H <= 32 * 8
                  : a.path == PATH_HASH    ? a.H <= MAX_H
                  : a.path == PATH_WIDE    ? a.H < WIDE_MAX_H && a.workspace != nullptr &&
                                              a.ws_blocks >= 1 && a.ws_blocks <= a.K
                                           : false;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.split) {
    if (a.K != 1 || a.H > SPLIT_MAX_H || a.set_in != nullptr || a.snap_vk != nullptr ||
        a.split_ws == nullptr || a.vsorted == nullptr || a.vorder == nullptr ||
        a.fallbacks == nullptr)
      return (int)cudaErrorInvalidValue;
    const int e = launch_split(a, s);
    if (e != 0) return e;
  } else if (a.split_ws != nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const long long ob = (a.K + 1 + 255) / 256;
  distinct_scan_offsets<<<(unsigned)(ob < 1024 ? ob : 1024), 256, 0, s>>>(a);
  const bool set = a.set_in != nullptr, emit = a.snap_vk != nullptr;
  const int e = set ? (emit ? launch<true, true>(a, s) : launch<true, false>(a, s))
                    : (emit ? launch<false, true>(a, s) : launch<false, false>(a, s));
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

// The split chain's workspace for one call, in int32 words.
extern "C" long long siddhi_distinct_split_words(long long H, long long R) {
  return split_layout(H, R).words;
}

extern "C" const char* siddhi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
