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
// Across processes (siddhi_peer_exchange_cols) the same chunk walk and
// bulk ring write straight into other processes' receive buffers: the
// CUDA form of the TPU kernel's make_async_remote_copy. Each process
// cudaMallocs one receive arena a column layout (siddhi_ipc_alloc), the
// processes trade its cudaIpcMemHandle once and map each other's arenas
// (siddhi_ipc_open); every arena has the same layout, so the table holds
// one base pointer a process and one offset a column (not ncols x P
// pointers), plus the per-call segment plan: for pair (s, d) of a source
// shard s of this process and a global destination shard d, the owner
// process q and the segment index in q's buffer of that column, computed
// in Python (ops/exchange.py peer_plan).
//
// Completion crosses processes through 64-bit generation words, the CUDA
// form of the TPU kernel's DMA semaphores. Each process keeps one page of
// words written[q] per arena in shared host memory (siddhi_words_create: a
// memfd, mapped by every process of the group through /proc/<pid>/fd and
// registered with the card): after its kernel of step k a process writes
// k + 1 into its word in every peer's page, and its stream waits until
// every peer's word in its own page is at least k + 1 (siddhi_stream_sync:
// cuStreamBatchMemOp's 64-bit writes and GEQ waits, from the driver
// through dlopen, so nothing links libcuda). The same waits free the other
// half for the next step, since a peer reads a step's result before its
// next call. A wait for "at least step k" is right whenever it is issued,
// so no host lines the processes up, and it waits in the card's front end:
// it holds no SM and launches nothing, which matters because without MPS
// the kernels of two processes on one card time-slice and a spinning
// kernel could wait a whole slice. Each write carries the stream's
// system-scope fence, so a peer that sees the word also sees the kernel's
// stores before it. The schedule of writes and waits is ops/exchange.py
// peer_schedule. The words live on the host so that a survivor releases
// its stream after a peer's death with a plain store: a release made with
// a driver call can block behind the launch queue its own stuck stream
// filled.
// Bound: bytes, every segment of the process's send buffers read once and
// written once.
//
// Built at first use by siddhi_tpu_torch/ops/_cuda.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; the C entry returns cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <fcntl.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>
#include <sys/mman.h>
#include <unistd.h>

namespace {

constexpr int MAX_COLS = 64;
constexpr long long CHUNK = 16384;      // bytes; a multiple of 16
constexpr int STAGES = 4;
constexpr int THREADS = 128;            // warp 0: bulk copies; warps 1-3: bytes
constexpr int SMEM_BYTES = STAGES * (int)CHUNK;
constexpr int MAX_DEVICES = 64;
constexpr int MAX_PEER_COLS = 32;       // columns one cross-process launch takes
constexpr int MAX_PROCS = 16;           // processes of a peer exchange
constexpr int MAX_PAIRS = 512;          // (source, destination) pairs a column
constexpr int MAX_SYNC = 2 * MAX_PROCS; // stream memory operations a batch
constexpr long long WORDS_BYTES = 4096;  // a page of generation words

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

}  // namespace

// One column across processes: this process's send buffer [L, n*Q, row],
// the offset of the column's receive buffer [L, n*Q, row] in every
// process's arena, and the bytes of one segment. Laid out as
// ops/exchange.py's ctypes _PeerCol.
struct PeerCol {
  const void* in;
  long long out_off;
  long long seg_bytes;
};

// One stream memory operation of the peer schedule: wait == 0 writes value
// at addr; wait != 0 waits until the 64-bit word at addr is at least value
// (flush: then flushes remote writes, where the card can). Laid out as
// ops/exchange.py's ctypes _PeerSync.
struct PeerSync {
  unsigned long long addr;
  unsigned long long value;
  int wait;
  int flush;
};

namespace {

struct PeerTable {
  PeerCol cols[MAX_PEER_COLS];
  long long first_chunk[MAX_PEER_COLS + 1];
  unsigned long long bases[MAX_PROCS];  // each process's arena, mapped here
  unsigned int plan[MAX_PAIRS];         // pair s*n + d: q << 24 | segment in q
  long long npairs;
  int ncols;
};
static_assert(sizeof(PeerTable) <= 4000, "kernel parameters are capped at 4 KB");

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

// The same for a cross-process table: pair p of a column reads segment p
// of the send buffer and writes the plan's segment of its owner's buffer.
__device__ __forceinline__ void chunk_at(const PeerTable& t, long long g,
                                         const uint8_t*& src, uint8_t*& dst,
                                         long long& len) {
  int c = 0;
  while (c + 1 < t.ncols && t.first_chunk[c + 1] <= g) ++c;
  const long long seg = t.cols[c].seg_bytes;
  const long long per = chunks_per_segment(seg);
  const long long local = g - t.first_chunk[c];
  const long long pair = local / per;
  const long long off = (local - pair * per) * CHUNK;
  const unsigned int e = t.plan[pair];
  const long long dseg = (long long)(e & 0xFFFFFFu);
  len = seg - off < CHUNK ? seg - off : CHUNK;
  src = static_cast<const uint8_t*>(t.cols[c].in) + pair * seg + off;
  dst = reinterpret_cast<uint8_t*>(t.bases[e >> 24] + (unsigned long long)t.cols[c].out_off)
        + dseg * seg + off;
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
template <class Table>
__device__ __forceinline__ bool next_body(const Table& t, long long total,
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

// One block's share of a table's chunk walk (both kernels below).
template <class Table>
__device__ __forceinline__ void exchange_body(const Table& t) {
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

// The table is a __grid_constant__ parameter: read in place, never copied.
__global__ void __launch_bounds__(THREADS)
ring_exchange_cols_kernel(const __grid_constant__ ColTable t) { exchange_body(t); }

__global__ void __launch_bounds__(THREADS)
peer_exchange_cols_kernel(const __grid_constant__ PeerTable t) { exchange_body(t); }

// Launch a table's kernel on a grid that stays resident; cache[dev] keeps
// each device's block count once the 64 KB of dynamic shared memory is
// allowed.
template <class Table>
int launch(void (*kernel)(Table), const Table& t, long long total, int* cache,
           void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, THREADS, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    cache[dev] = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }
  const long long blocks = total < cache[dev] ? total : cache[dev];
  kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(t);
  return (int)cudaGetLastError();
}

int g_max_blocks[MAX_DEVICES];          // resident blocks per device, 0: unset
int g_max_blocks_peer[MAX_DEVICES];

static_assert(sizeof(cudaIpcMemHandle_t) == 64, "64-byte memory handles");

// The driver's stream memory operations, reached through dlopen of the
// driver library the runtime has already loaded (no link to libcuda).
typedef CUresult (*BatchMemOpFn)(CUstream, unsigned int, CUstreamBatchMemOpParams*,
                                 unsigned int);
typedef CUresult (*DeviceGetFn)(CUdevice*, int);
typedef CUresult (*DeviceGetAttributeFn)(int*, CUdevice_attribute, CUdevice);

struct Driver {
  BatchMemOpFn batch;
  DeviceGetFn device_get;
  DeviceGetAttributeFn attribute;
};

const Driver& driver() {
  static const Driver d = [] {
    Driver r{};
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (lib != nullptr) {
      r.batch = (BatchMemOpFn)dlsym(lib, "cuStreamBatchMemOp_v2");
      r.device_get = (DeviceGetFn)dlsym(lib, "cuDeviceGet");
      r.attribute = (DeviceGetAttributeFn)dlsym(lib, "cuDeviceGetAttribute");
    }
    return r;
  }();
  return d;
}

// Register a page of generation words with the card; *dev its address
// there.
int register_words(void* host, unsigned long long* dev) {
  cudaError_t err = cudaHostRegister(host, WORDS_BYTES,
                                     cudaHostRegisterMapped | cudaHostRegisterPortable);
  if (err != cudaSuccess) return (int)err;
  void* d = nullptr;
  err = cudaHostGetDevicePointer(&d, host, 0);
  if (err != cudaSuccess) {
    cudaHostUnregister(host);
    return (int)err;
  }
  *dev = (unsigned long long)(uintptr_t)d;
  return 0;
}

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
  return launch(ring_exchange_cols_kernel, t, total, g_max_blocks, stream);
}

// Every column's npairs segments of this process's send buffers into
// their owners' receive buffers: bases[q] is process q's arena as mapped
// here (this process's own for q == its rank), plan[pair] = q << 24 |
// segment index in q's buffer. One launch; nothing waits on a peer here
// (the caller's siddhi_stream_sync after it does).
extern "C" int siddhi_peer_exchange_cols(const PeerCol* cols, int ncols,
                                         const unsigned long long* bases,
                                         int nprocs, const unsigned int* plan,
                                         int npairs, void* stream) {
  if (ncols < 0 || ncols > MAX_PEER_COLS || nprocs <= 0 || nprocs > MAX_PROCS
      || npairs <= 0 || npairs > MAX_PAIRS)
    return (int)cudaErrorInvalidValue;
  PeerTable t;
  t.ncols = ncols;
  t.npairs = npairs;
  for (int q = 0; q < nprocs; ++q) {
    if (bases[q] == 0) return (int)cudaErrorInvalidValue;
    t.bases[q] = bases[q];
  }
  for (int i = 0; i < npairs; ++i) {
    if ((int)(plan[i] >> 24) >= nprocs) return (int)cudaErrorInvalidValue;
    t.plan[i] = plan[i];
  }
  long long total = 0;
  for (int c = 0; c < ncols; ++c) {
    if (cols[c].seg_bytes < 0 || cols[c].out_off < 0) return (int)cudaErrorInvalidValue;
    t.cols[c] = cols[c];
    t.first_chunk[c] = total;
    total += (long long)npairs * chunks_per_segment(cols[c].seg_bytes);
  }
  t.first_chunk[ncols] = total;
  if (total == 0) return 0;
  return launch(peer_exchange_cols_kernel, t, total, g_max_blocks_peer, stream);
}

// ---- the receive arenas and the generation words, across processes ----

// One receive arena: cudaMalloc (so the handle names exactly this block,
// not a caching allocator's larger one), zeroed before it returns (a half
// that a dead peer never wrote reads as rows whose flags are all 0, not
// as whatever the allocation held), and its 64-byte IPC handle.
extern "C" int siddhi_ipc_alloc(long long bytes, void** ptr, void* handle) {
  if (bytes <= 0) return (int)cudaErrorInvalidValue;
  void* p = nullptr;
  cudaError_t err = cudaMalloc(&p, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemset(p, 0, (size_t)bytes);
  if (err == cudaSuccess) err = cudaStreamSynchronize(0);
  if (err != cudaSuccess) {
    cudaFree(p);
    return (int)err;
  }
  cudaIpcMemHandle_t h;
  err = cudaIpcGetMemHandle(&h, p);
  if (err != cudaSuccess) {
    cudaFree(p);
    return (int)err;
  }
  memcpy(handle, &h, sizeof(h));
  *ptr = p;
  return 0;
}

extern "C" int siddhi_ipc_free(void* ptr) { return (int)cudaFree(ptr); }

// Another process's arena, mapped into this one (peer access enabled on
// first use where the arena lies on another card).
extern "C" int siddhi_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int siddhi_ipc_close(void* ptr) { return (int)cudaIpcCloseMemHandle(ptr); }

// This process's page of generation words: a zeroed page of an anonymous
// shared file (memfd), mapped here at *host and registered with the card
// at *dev; *fd stays open for the peers to map it (siddhi_words_open).
extern "C" int siddhi_words_create(int* fd, void** host, unsigned long long* dev) {
  const int f = memfd_create("siddhi-peer-words", MFD_CLOEXEC);
  if (f < 0) return (int)cudaErrorOperatingSystem;
  void* p = MAP_FAILED;
  if (ftruncate(f, WORDS_BYTES) == 0)
    p = mmap(nullptr, WORDS_BYTES, PROT_READ | PROT_WRITE, MAP_SHARED, f, 0);
  if (p == MAP_FAILED) {
    close(f);
    return (int)cudaErrorOperatingSystem;
  }
  const int code = register_words(p, dev);
  if (code) {
    munmap(p, WORDS_BYTES);
    close(f);
    return code;
  }
  *fd = f;
  *host = p;
  return 0;
}

// Process pid's page of generation words (its memfd fd), mapped here and
// registered with the card.
extern "C" int siddhi_words_open(int pid, int fd, void** host, unsigned long long* dev) {
  char path[64];
  snprintf(path, sizeof(path), "/proc/%d/fd/%d", pid, fd);
  const int f = open(path, O_RDWR | O_CLOEXEC);
  if (f < 0) return (int)cudaErrorOperatingSystem;
  void* p = mmap(nullptr, WORDS_BYTES, PROT_READ | PROT_WRITE, MAP_SHARED, f, 0);
  close(f);
  if (p == MAP_FAILED) return (int)cudaErrorOperatingSystem;
  const int code = register_words(p, dev);
  if (code) {
    munmap(p, WORDS_BYTES);
    return code;
  }
  *host = p;
  return 0;
}

extern "C" int siddhi_words_close(void* host) {
  const cudaError_t err = cudaHostUnregister(host);
  munmap(host, WORDS_BYTES);
  return (int)err;
}

extern "C" int siddhi_fd_close(int fd) {
  return close(fd) == 0 ? 0 : (int)cudaErrorOperatingSystem;
}

// Whether the current device takes 64-bit stream memory operations
// (*ok), and flushes remote writes after a wait (*flush). Returns a CUDA
// error code where the driver cannot be asked.
extern "C" int siddhi_stream_memops(int* ok, int* flush) {
  const Driver& drv = driver();
  if (drv.batch == nullptr || drv.device_get == nullptr || drv.attribute == nullptr)
    return (int)cudaErrorSharedObjectSymbolNotFound;
  int ordinal = 0;
  cudaError_t err = cudaGetDevice(&ordinal);
  if (err != cudaSuccess) return (int)err;
  CUdevice dev;
  CUresult r = drv.device_get(&dev, ordinal);
  if (r == CUDA_SUCCESS)
    r = drv.attribute(ok, CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS, dev);
  if (r == CUDA_SUCCESS)
    r = drv.attribute(flush, CU_DEVICE_ATTRIBUTE_CAN_FLUSH_REMOTE_WRITES, dev);
  return (int)r;
}

// The peer schedule's writes and waits, in order, on the caller's stream.
extern "C" int siddhi_stream_sync(const PeerSync* ops, int n, void* stream) {
  if (n < 0 || n > MAX_SYNC) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Driver& drv = driver();
  if (drv.batch == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  CUstreamBatchMemOpParams p[MAX_SYNC];
  memset(p, 0, sizeof(p));
  for (int i = 0; i < n; ++i) {
    if (ops[i].wait) {
      p[i].waitValue.operation = CU_STREAM_MEM_OP_WAIT_VALUE_64;
      p[i].waitValue.address = (CUdeviceptr)ops[i].addr;
      p[i].waitValue.value64 = ops[i].value;
      p[i].waitValue.flags = CU_STREAM_WAIT_VALUE_GEQ
                             | (ops[i].flush ? CU_STREAM_WAIT_VALUE_FLUSH : 0);
    } else {
      p[i].writeValue.operation = CU_STREAM_MEM_OP_WRITE_VALUE_64;
      p[i].writeValue.address = (CUdeviceptr)ops[i].addr;
      p[i].writeValue.value64 = ops[i].value;
      p[i].writeValue.flags = CU_STREAM_WRITE_VALUE_DEFAULT;
    }
  }
  return (int)drv.batch((CUstream)stream, (unsigned)n, p, 0);
}

extern "C" const char* siddhi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
