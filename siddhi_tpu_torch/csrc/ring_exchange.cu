// ring_exchange: the shard exchange of the device-routed query step, every
// column of a routed batch in one launch.
//
// Replaces the TPU kernel siddhi_tpu/parallel/mesh.py:1242
// (_pallas_ring_exchange), which pushes segment d of every shard's send
// buffer to shard d with remote DMAs under shard_map. On one card the n
// logical shards' buffers of one column sit side by side in one
// [n, n*Q, row] tensor, so the exchange of that column is one on-card copy:
//
//     out[d][s*Q:(s+1)*Q] = in[s][d*Q:(d+1)*Q]     (rows source-major)
//
// Bound: bytes. Nothing is computed; a call reads and writes every
// column once, 2 * sum over columns of n*n*Q*row bytes. At the flagship's
// shapes (n = 4, Q = 5,120, 12 columns of 1 to 8 bytes) that is 3,686,400
// bytes each way per batch, 2.2 us at the H100's 3.35 TB/s.
//
// The first version took one column per launch: 12 launches per routed
// batch, each behind its own host call, so it was launch-bound (~100x its
// byte bound, slower than 12 PyTorch copies). This design:
//   - one launch per call of up to MAX_COLS columns: the column table is a
//     __grid_constant__ kernel parameter, filled on the host and passed by
//     value, so nothing is copied host to device before the launch;
//   - byte-balanced work: every (column, source s, destination d) segment
//     is contiguous on both sides (in + (s*n + d)*seg goes to
//     out + (d*n + s)*seg) and is cut into chunks of at most CHUNK bytes;
//     the table carries each column's first chunk id, and a grid of a few
//     blocks per SM walks the flat chunk list, so a 1-byte mask column gets
//     a share of the work in proportion to its bytes, not one per column;
//   - bulk asynchronous copies: for the 16-byte aligned body of a chunk one
//     thread issues cp.async.bulk global -> shared (completion on an
//     mbarrier), then cp.async.bulk shared -> global (bulk group), over a
//     ring of STAGES shared-memory stages so the next loads are in flight
//     while a store drains. The unaligned head and tail of a chunk, and
//     whole chunks whose two ends are not aligned alike, are copied as
//     bytes by the block's other warps in the same kernel.
//
// Built at first use by siddhi_tpu_torch/ops/_cuda.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_COLS = 64;
constexpr long long CHUNK = 16384;      // bytes; a multiple of 16
constexpr int STAGES = 4;
constexpr int THREADS = 128;            // warp 0: bulk copies; warps 1-3: bytes
constexpr int SMEM_BYTES = STAGES * (int)CHUNK;
constexpr int MAX_DEVICES = 64;

}  // namespace

// One column: its send buffer [n, n*Q, row], its output of the same shape,
// and the bytes of one (source, destination) segment, Q * row bytes.
// Laid out as ops/exchange.py's ctypes _ExchangeCol.
struct ExchangeCol {
  const void* in;
  void* out;
  long long seg_bytes;
};

namespace {

struct ColTable {
  ExchangeCol cols[MAX_COLS];
  long long first_chunk[MAX_COLS + 1];  // prefix of chunk counts
  long long n;
  int ncols;
};
static_assert(sizeof(ColTable) <= 4000, "kernel parameters are capped at 4 KB");

__host__ __device__ __forceinline__ long long chunks_per_segment(long long seg_bytes) {
  return (seg_bytes + CHUNK - 1) / CHUNK;
}

// Source, destination and length of flat chunk g.
__device__ __forceinline__ void chunk_at(const ColTable& t, long long g,
                                         const uint8_t*& src, uint8_t*& dst,
                                         long long& len) {
  int c = 0;
  while (c + 1 < t.ncols && t.first_chunk[c + 1] <= g) ++c;
  const long long seg = t.cols[c].seg_bytes;
  const long long per = chunks_per_segment(seg);
  const long long local = g - t.first_chunk[c];
  const long long pair = local / per;
  const long long off = (local - pair * per) * CHUNK;
  const long long s = pair / t.n, d = pair - s * t.n;
  len = seg - off < CHUNK ? seg - off : CHUNK;
  src = static_cast<const uint8_t*>(t.cols[c].in) + (s * t.n + d) * seg + off;
  dst = static_cast<uint8_t*>(t.cols[c].out) + (d * t.n + s) * seg + off;
}

// A chunk's 16-byte aligned body [head, head + body): empty when its two
// ends are not aligned alike.
__device__ __forceinline__ void split(const uint8_t* src, const uint8_t* dst,
                                      long long len, long long& head,
                                      long long& body) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t b = reinterpret_cast<uintptr_t>(dst);
  if ((a ^ b) & 15) {
    head = len;
    body = 0;
    return;
  }
  head = (long long)((16 - (a & 15)) & 15);
  if (head > len) head = len;
  body = (len - head) & ~15LL;
}

struct Body {
  const uint8_t* src;
  uint8_t* dst;
  uint32_t bytes;
};

// Advance cursor g (this block's chunks) to the next chunk with a bulk body.
__device__ __forceinline__ bool next_body(const ColTable& t, long long total,
                                          long long& g, Body& out) {
  for (; g < total; g += gridDim.x) {
    const uint8_t* src;
    uint8_t* dst;
    long long len, head, body;
    chunk_at(t, g, src, dst, len);
    split(src, dst, len, head, body);
    if (body > 0) {
      out = {src + head, dst + head, (uint32_t)body};
      g += gridDim.x;
      return true;
    }
  }
  return false;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t stage, uint32_t bar,
                                          const Body& b) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(b.bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(stage), "l"(b.src), "r"(b.bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_store(uint32_t stage, const Body& b) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(b.dst), "r"(stage), "r"(b.bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(THREADS)
ring_exchange_cols_kernel(const __grid_constant__ ColTable t) {
  extern __shared__ __align__(128) uint8_t stage_mem[];
  __shared__ __align__(8) uint64_t bars[STAGES];
  const long long total = t.first_chunk[t.ncols];

  if (threadIdx.x == 0) {
    // the bulk pipeline: up to STAGES - 1 loads in flight; a stage is
    // refilled only once the store issued from it one step earlier has
    // read it (wait_group.read 1 leaves just the newest store pending)
    for (int i = 0; i < STAGES; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(&bars[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    Body pend[STAGES];
    long long cur = blockIdx.x;
    int issued = 0;
    while (issued < STAGES - 1 && next_body(t, total, cur, pend[issued])) {
      bulk_load(smem_addr(stage_mem + issued * CHUNK), smem_addr(&bars[issued]),
                pend[issued]);
      ++issued;
    }
    for (int done = 0; done < issued; ++done) {
      const int st = done % STAGES;
      mbar_wait(smem_addr(&bars[st]), (uint32_t)((done / STAGES) & 1));
      bulk_store(smem_addr(stage_mem + st * CHUNK), pend[st]);
      const int nx = issued % STAGES;
      Body b;
      if (next_body(t, total, cur, b)) {
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        pend[nx] = b;
        bulk_load(smem_addr(stage_mem + nx * CHUNK), smem_addr(&bars[nx]), b);
        ++issued;
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  } else if (threadIdx.x >= 32) {
    // bytes outside the bulk bodies: heads, tails, unaligned chunks
    const long long lane = threadIdx.x - 32, lanes = blockDim.x - 32;
    for (long long g = blockIdx.x; g < total; g += gridDim.x) {
      const uint8_t* src;
      uint8_t* dst;
      long long len, head, body;
      chunk_at(t, g, src, dst, len);
      split(src, dst, len, head, body);
      const long long tail = head + body;
      const long long nbytes = head + (len - tail);
      for (long long i = lane; i < nbytes; i += lanes) {
        const long long o = i < head ? i : tail + (i - head);
        dst[o] = src[o];
      }
    }
  }
}

int g_max_blocks[MAX_DEVICES];          // resident blocks per device, 0: unset

}  // namespace

extern "C" int siddhi_ring_exchange_cols(const ExchangeCol* cols, int ncols,
                                         long long n, void* stream) {
  if (n <= 0 || ncols < 0 || ncols > MAX_COLS) return (int)cudaErrorInvalidValue;
  ColTable t;
  t.n = n;
  t.ncols = ncols;
  long long total = 0;
  for (int c = 0; c < ncols; ++c) {
    if (cols[c].seg_bytes < 0) return (int)cudaErrorInvalidValue;
    t.cols[c] = cols[c];
    t.first_chunk[c] = total;
    total += n * n * chunks_per_segment(cols[c].seg_bytes);
  }
  t.first_chunk[ncols] = total;
  if (total == 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (g_max_blocks[dev] == 0) {
    // once per device: allow the 64 KB of dynamic shared memory, then size
    // the grid to what stays resident
    err = cudaFuncSetAttribute(ring_exchange_cols_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ring_exchange_cols_kernel, THREADS, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    g_max_blocks[dev] = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }
  const long long blocks = total < g_max_blocks[dev] ? total : g_max_blocks[dev];
  ring_exchange_cols_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES,
                              static_cast<cudaStream_t>(stream)>>>(t);
  return (int)cudaGetLastError();
}

extern "C" const char* siddhi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
