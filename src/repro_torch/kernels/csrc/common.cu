// Shared C entry points of the port's kernel library (libreprokernels.so).
//
// Every kernel entry point in this directory launches on the stream it is
// given and returns cudaGetLastError() as an int, or, where a TMA tensor map
// could not be encoded, hopper::kTensorMapError + the CUresult; the Python
// wrappers turn a non-zero status into an exception with the message below.

#include <stdio.h>

#include "hopper.cuh"

extern "C" const char* repro_cuda_error_string(int status) {
  if (status >= hopper::kTensorMapError) {
    static thread_local char msg[96];
    snprintf(msg, sizeof(msg), "cuTensorMapEncodeTiled failed (CUresult %d)",
             status - hopper::kTensorMapError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
