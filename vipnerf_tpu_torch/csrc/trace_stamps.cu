// Device timestamps for the tracer's spans inside a captured CUDA graph
// (vipnerf_tpu_torch/utils/tracing.py `Recording`).
//
// A CUDA event recorded while a stream is captured marks a dependency, not a
// time, so a span timed on the device inside a graph takes its two ends from
// the device's global timer instead: one thread writes %globaltimer (ns) into
// its slot of the row that the current replay owns. The row lives on the
// device and the graph's last node advances it, so each replay writes a row
// of its own without the host touching the graph. The stamps are pinned host
// memory, mapped into the device's address space: the host reads a replay's
// row once that replay has finished, with no copy and no wait on the stream.

#include <cuda_runtime.h>

__global__ void trace_stamp_kernel(unsigned long long* stamps, const int* row, int slots, int slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  stamps[(size_t)(*row) * slots + slot] = t;
}

__global__ void trace_advance_kernel(int* row, int rows) { *row = (*row + 1) % rows; }

// *dev = the device's address of pinned host memory `host`; an error where it is not mapped.
extern "C" int vipnerf_trace_device_pointer(void* host, void** dev) {
  const cudaError_t e = cudaHostGetDevicePointer(dev, host, 0);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// stamps[row][slot] = the global timer, row read from the device; one launch on the stream.
extern "C" int vipnerf_trace_stamp(void* stamps, const void* row, int slots, int slot, void* stream) {
  if (!stamps || !row || slot < 0 || slot >= slots) return (int)cudaErrorInvalidValue;
  trace_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((unsigned long long*)stamps, (const int*)row, slots, slot);
  return (int)cudaGetLastError();
}

// row = (row + 1) % rows on the device; one launch on the stream.
extern "C" int vipnerf_trace_advance(void* row, int rows, void* stream) {
  if (!row || rows <= 0) return (int)cudaErrorInvalidValue;
  trace_advance_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((int*)row, rows);
  return (int)cudaGetLastError();
}
