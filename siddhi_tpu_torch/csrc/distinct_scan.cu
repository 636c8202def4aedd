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
  const long long ob = (a.K + 1 + 255) / 256;
  distinct_scan_offsets<<<(unsigned)(ob < 1024 ? ob : 1024), 256, 0, s>>>(a);
  const bool set = a.set_in != nullptr, emit = a.snap_vk != nullptr;
  const int e = set ? (emit ? launch<true, true>(a, s) : launch<true, false>(a, s))
                    : (emit ? launch<false, true>(a, s) : launch<false, false>(a, s));
  if (e != 0) return e;
  return (int)cudaGetLastError();
}

extern "C" const char* siddhi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
