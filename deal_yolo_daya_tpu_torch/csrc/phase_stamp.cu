// Phase stamps of the train step for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces no TPU kernel: the JAX package reads its step's phases from
// jax.profiler's named scopes, which have no counterpart inside a CUDA graph.
// A stamp is a one-thread kernel that writes the card's global nanosecond
// timer (%globaltimer) into a ring in device memory,
//
//     ring[(count % steps) * SLOTS + slot] = %globaltimer,   count = ring[steps * SLOTS]
//
// and the last slot's stamp advances the count. The count lives in device
// memory, so a CUDA graph that captured the stamps writes each replay's step
// into its own row. There is one kernel a slot, named by the phase the slot
// opens (dyd_stamp_<slot>_<phase>), so a profiler trace shows the phase from
// the kernel's name alone.
//
// A mark is a point inside a phase for the profiler's timeline alone: an
// empty one-thread kernel named dyd_mark_<phase>_<what>, which the slots'
// pattern dyd_stamp_<slot>_ does not match. The one mark is
// dyd_mark_loss_o2o, between YOLOv10's two heads' assignments in the loss.
//
// What bounds it: the launch, about 2 us of device time; it reads 8 bytes
// and writes 8 or 16. The stamps of one step run in order on one stream, so
// no two of them touch the ring at once and no atomics are needed.
//
// The launch allocates nothing. The C entry returns cudaGetLastError() so the
// Python wrapper can raise.

#include <cuda_runtime.h>

namespace {

constexpr int SLOTS = 6;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void stamp(unsigned long long* ring, int steps, int slot) {
  unsigned long long* count = ring + static_cast<long long>(steps) * SLOTS;
  const unsigned long long c = *count;
  ring[(c % static_cast<unsigned long long>(steps)) * SLOTS + slot] = global_ns();
  if (slot == SLOTS - 1) *count = c + 1;
}

}  // namespace

#define DYD_STAMP(SLOT, PHASE)                                                            \
  __global__ void dyd_stamp_##SLOT##_##PHASE(unsigned long long* ring, int steps) {       \
    stamp(ring, steps, SLOT);                                                             \
  }

DYD_STAMP(0, augment)
DYD_STAMP(1, forward)
DYD_STAMP(2, loss)
DYD_STAMP(3, backward)
DYD_STAMP(4, optimizer)
DYD_STAMP(5, end)

__global__ void dyd_mark_loss_o2o() {}

// Stamp `slot` (0-5) into `ring`, (steps * 6 + 1) u64, on `stream`. Returns 0
// on a good launch, else the CUDA error code.
extern "C" int phase_stamp(void* ring, int steps, int slot, void* stream) {
  if (ring == nullptr || steps < 1 || slot < 0 || slot >= SLOTS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* r = static_cast<unsigned long long*>(ring);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (slot) {
    case 0: dyd_stamp_0_augment<<<1, 1, 0, s>>>(r, steps); break;
    case 1: dyd_stamp_1_forward<<<1, 1, 0, s>>>(r, steps); break;
    case 2: dyd_stamp_2_loss<<<1, 1, 0, s>>>(r, steps); break;
    case 3: dyd_stamp_3_backward<<<1, 1, 0, s>>>(r, steps); break;
    case 4: dyd_stamp_4_optimizer<<<1, 1, 0, s>>>(r, steps); break;
    default: dyd_stamp_5_end<<<1, 1, 0, s>>>(r, steps); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The mark dyd_mark_loss_o2o on `stream`. Returns 0 on a good launch, else
// the CUDA error code.
extern "C" int phase_mark(void* stream) {
  dyd_mark_loss_o2o<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
