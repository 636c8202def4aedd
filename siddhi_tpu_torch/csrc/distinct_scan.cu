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
// Rows of different groups are independent, which is all this design
// uses. The wrapper (ops/distinct.py) sorts the row indices stably by
// group, gathers the row inputs into that order and builds CSR offsets;
// a warp takes one group at a time (grid-stride). Lane l holds slots
// l, l+32, ... of the group's table in registers (C = H/32 rounded up to a
// power of two, so H <= 1024). The first match and the first empty slot
// come from one __ballot_sync per register column and __ffs, the live
// count is kept incrementally (seeded by __popc of the live ballots), and
// the updated slot belongs to one lane. Row inputs are read 32 at a time,
// one per lane, and broadcast with __shfl_sync. The table and the stamp
// are written back once per group, so the state is updated IN PLACE.
//
// Bound: bytes across groups (each touched group's [H] table read and
// written once, ~37 bytes per row in and out), and the serial chain of
// the largest group: a batch without `group by` is one chain of every
// row, walked by one warp.
//
// Built at first use by siddhi_tpu_torch/ops/_cuda.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

// Laid out as ops/distinct.py's ctypes _ScanArgs.
struct ScanArgs {
  int64_t* vk;               // [K, H] value codes (updated in place)
  int32_t* vc;               // [K, H] counts: -1 never used, 0 dead
  int64_t* stamp;            // [K] epoch of the group's last applied row
  long long K;
  long long H;
  const int64_t* offsets;    // [K + 1] each group's range of sorted rows
  const int64_t* order;      // [R] original row of each sorted position
  const int64_t* v;          // [R] value codes, sorted (null with set_in)
  const int32_t* delta;      // [R] +1 / -1, sorted
  const uint8_t* part;       // [R] row participates, sorted
  const int64_t* ep;         // [R] absolute epoch of the row, sorted
  const int64_t* set_in;     // [R, cin] element codes, sorted, or null
  const uint8_t* set_in_m;   // [R, cin] element present, sorted, or null
  long long cin;
  int64_t* nd;               // [R] live count after each row (original order)
  int64_t* snap_vk;          // [R, H] keys after each row, or null
  uint8_t* snap_live;        // [R, H] live mask after each row, or null
  int32_t* overflow;         // [1] set to 1 when a row found no slot
};

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 4;
constexpr int MAX_BLOCKS = 8192;

__device__ __forceinline__ int64_t shfl64(int64_t v, int src) {
  return (int64_t)__shfl_sync(FULL, (long long)v, src);
}

// One element into the warp's table. ``fresh``: the table still reads as
// empty for this row; the reset is written on the first applied element.
template <int C>
__device__ __forceinline__ void insert_one(int64_t (&key)[C], int32_t (&cnt)[C],
                                           int H, int lane, int64_t val,
                                           int32_t d, bool p, bool& fresh,
                                           int& live, bool& applied,
                                           bool& overflowed) {
  int slot = -1;
  int empty = -1;
  bool has = false;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const bool in = c * 32 + lane < H;
    const bool occ = !fresh && cnt[c] > 0;
    const unsigned mb = __ballot_sync(FULL, in && occ && key[c] == val);
    if (mb) {
      has = true;
      slot = c * 32 + __ffs(mb) - 1;
      break;
    }
    if (empty < 0) {
      const unsigned eb = __ballot_sync(FULL, in && !occ);
      if (eb) empty = c * 32 + __ffs(eb) - 1;
    }
  }
  if (!has) slot = empty;
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

template <int C>
__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
distinct_scan_kernel(const ScanArgs a) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const int H = (int)a.H;
  bool overflowed = false;
  for (long long g = warp; g < a.K; g += n_warps) {
    const long long lo = a.offsets[g];
    const long long hi = a.offsets[g + 1];
    if (lo >= hi) continue;
    int64_t* vk_row = a.vk + g * H;
    int32_t* vc_row = a.vc + g * H;
    int64_t key[C];
    int32_t cnt[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int s = c * 32 + lane;
      key[c] = s < H ? vk_row[s] : 0;
      cnt[c] = s < H ? vc_row[s] : 0;
    }
    int64_t st = a.stamp[g];
    int live = 0;               // live slots of the table as stored
#pragma unroll
    for (int c = 0; c < C; ++c)
      live += __popc(__ballot_sync(FULL, c * 32 + lane < H && cnt[c] > 0));

    for (long long base = lo; base < hi; base += 32) {
      const long long mine = base + lane;
      const bool in = mine < hi;
      const int64_t my_row = in ? a.order[mine] : 0;
      const int64_t my_v = (in && a.v != nullptr) ? a.v[mine] : 0;
      const int32_t my_d = in ? a.delta[mine] : 0;
      const int my_p = in ? (int)a.part[mine] : 0;
      const int64_t my_e = in ? a.ep[mine] : 0;
      int64_t my_nd = 0;
      const int n = (int)(hi - base < 32 ? hi - base : 32);
      for (int j = 0; j < n; ++j) {
        const int64_t row = shfl64(my_row, j);
        const int32_t d = __shfl_sync(FULL, my_d, j);
        const bool p = __shfl_sync(FULL, my_p, j) != 0;
        const int64_t e = shfl64(my_e, j);
        bool fresh = st != e;
        bool applied = false;
        if (a.set_in == nullptr) {
          const int64_t val = shfl64(my_v, j);
          insert_one<C>(key, cnt, H, lane, val, d, p, fresh, live, applied,
                        overflowed);
        } else {
          const long long r = base + j;
          for (long long c0 = 0; c0 < a.cin; c0 += 32) {
            const long long cc = c0 + lane;
            const int64_t my_el = cc < a.cin ? a.set_in[r * a.cin + cc] : 0;
            const int my_em = cc < a.cin ? (int)a.set_in_m[r * a.cin + cc] : 0;
            const int m = (int)(a.cin - c0 < 32 ? a.cin - c0 : 32);
            for (int k = 0; k < m; ++k) {
              const int64_t val = shfl64(my_el, k);
              const bool pe = p && __shfl_sync(FULL, my_em, k) != 0;
              insert_one<C>(key, cnt, H, lane, val, d, pe, fresh, live,
                            applied, overflowed);
            }
          }
        }
        if (applied) st = e;
        if (lane == j) my_nd = fresh ? 0 : live;
        if (a.snap_vk != nullptr) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int s = c * 32 + lane;
            if (s < H) {
              a.snap_vk[row * H + s] = key[c];
              a.snap_live[row * H + s] = (!fresh && cnt[c] > 0) ? 1 : 0;
            }
          }
        }
      }
      if (in) a.nd[my_row] = my_nd;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int s = c * 32 + lane;
      if (s < H) {
        vk_row[s] = key[c];
        vc_row[s] = cnt[c];
      }
    }
    if (lane == 0) a.stamp[g] = st;
  }
  if (overflowed && lane == 0) atomicOr(a.overflow, 1);
}

}  // namespace

extern "C" int siddhi_distinct_scan(const ScanArgs* args, void* stream) {
  const ScanArgs a = *args;
  if (a.K < 1 || a.H < 1 || a.H > 1024 || a.cin < 0)
    return (int)cudaErrorInvalidValue;
  long long blocks = (a.K + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const dim3 grid((unsigned)blocks), block(WARPS_PER_BLOCK * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cols = (a.H + 31) / 32;
  if (cols <= 1) distinct_scan_kernel<1><<<grid, block, 0, s>>>(a);
  else if (cols <= 2) distinct_scan_kernel<2><<<grid, block, 0, s>>>(a);
  else if (cols <= 4) distinct_scan_kernel<4><<<grid, block, 0, s>>>(a);
  else if (cols <= 8) distinct_scan_kernel<8><<<grid, block, 0, s>>>(a);
  else if (cols <= 16) distinct_scan_kernel<16><<<grid, block, 0, s>>>(a);
  else distinct_scan_kernel<32><<<grid, block, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* siddhi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
