// ring_exchange: the shard exchange of the device-routed query step.
//
// Replaces the TPU kernel siddhi_tpu/parallel/mesh.py:1242
// (_pallas_ring_exchange), which pushes segment d of every shard's send
// buffer to shard d with remote DMAs under shard_map. On one card the n
// logical shards' buffers sit side by side in one [n, n*Q, row] tensor, so
// the exchange is one on-card copy:
//
//     out[d][s*Q:(s+1)*Q] = in[s][d*Q:(d+1)*Q]     (rows source-major)
//
// Bound: bytes. Nothing is computed; each launch reads and writes the whole
// buffer once, 2 * n * n*Q * row bytes. At the flagship's shapes (n = 4,
// Q = 5,120, ~12 columns of <= 8 bytes) that is ~3.7 MB each way per batch,
// ~2.2 us at the H100's 3.35 TB/s, so one launch per column is launch-bound
// (folding all columns into one launch is later work).
//
// Design: grid.y walks the n*n (source, destination) segments; grid.x
// blocks stride over one segment with 16-byte vector copies when both
// segment starts are 16-byte aligned, then copy the byte tail (or every
// byte, when unaligned). The kernel works on bytes, so every dtype (bool
// travels as uint8) and any row width take the same path.
//
// Built at first use by siddhi_tpu_torch/ops/_cuda.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void ring_exchange_kernel(const uint8_t* __restrict__ in,
                                     uint8_t* __restrict__ out,
                                     long long n, long long seg_bytes) {
  const long long s = blockIdx.y / n;            // source shard
  const long long d = blockIdx.y % n;            // destination shard
  const long long shard_bytes = n * seg_bytes;   // one shard's buffer
  const uint8_t* src = in + s * shard_bytes + d * seg_bytes;
  uint8_t* dst = out + d * shard_bytes + s * seg_bytes;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const long long nvec = seg_bytes >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (long long i = tid; i < nvec; i += stride) d4[i] = s4[i];
    done = nvec << 4;
  }
  for (long long i = done + tid; i < seg_bytes; i += stride) dst[i] = src[i];
}

}  // namespace

extern "C" int siddhi_ring_exchange(const void* in, void* out, long long n,
                                    long long seg_bytes, void* stream) {
  if (n <= 0 || seg_bytes <= 0) return 0;
  if (n * n > 65535) return (int)cudaErrorInvalidValue;   // grid.y limit
  const int threads = 256;
  long long blocks = ((seg_bytes + 15) / 16 + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > 1024) blocks = 1024;
  dim3 grid((unsigned)blocks, (unsigned)(n * n));
  ring_exchange_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), n, seg_bytes);
  return (int)cudaGetLastError();
}

extern "C" const char* siddhi_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
