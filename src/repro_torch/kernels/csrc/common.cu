// Shared C entry points of the port's kernel library (libreprokernels.so).
//
// Every kernel entry point in this directory launches on the stream it is
// given and returns cudaGetLastError() as an int; the Python wrappers turn
// a non-zero status into an exception with the message below.

#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
