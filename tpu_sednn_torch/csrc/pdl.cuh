// Programmatic dependent launch (Hopper, sm_90) for the chunk trainer's
// chain of layer kernels (resident_chunk.cu:train_chunk).
//
// A kernel launched with cudaLaunchAttributeProgrammaticStreamSerialization
// may start while the launch before it on the stream still runs: as soon as
// every block of that launch has executed griddepcontrol.launch_dependents
// or exited.  It then does the part of its prologue that does not depend on
// that launch, and blocks at griddepcontrol.wait until that launch has
// completed and its memory is visible.
//
// The hazard rule (ops/resident_chunk.py:early_read_plan decides it, the
// kernels obey): every thread of a kernel of the chain executes
// griddepcontrol.wait before it writes anything or reads anything the launch
// just before may write, and launch_dependents only after that wait.  So
// when launch n+1 starts, every block of launch n has passed its wait, every
// launch up to n-1 has completed, and their writes are visible: launch n+1
// may read before its wait exactly the operands that launch n does not
// write.  The plan names them in three groups, one bit each.  A kernel
// launched without the attribute (the first of a call, and every standalone
// wrapper's) starts after its predecessor has completed; its wait returns at
// once.

#pragma once

#include <cuda_runtime.h>

namespace sednn {

// early_read_plan's bits: what a launch may read before its wait
constexpr int kEarlyW = 1;      // the layer's W (and b)
constexpr int kEarlyDelta = 2;  // the layer's Delta (and its bias's)
constexpr int kEarlyYprev = 4;  // the backward's yprev, the layer's input

// blocks until the launch before has completed and its writes are visible
__device__ inline void grid_dep_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// lets the next launch of the stream start (this block's first call counts)
__device__ inline void grid_dep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The launch attributes of a tensor-core layer kernel: its cluster along
// axis x or z, and with pdl the programmatic stream serialization.
// -> the number of attributes set.
inline unsigned cluster_launch_attrs(cudaLaunchAttribute* attr, int cx, int cz, bool pdl) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cx;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cz;
  if (!pdl) return 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  return 2;
}

}  // namespace sednn
