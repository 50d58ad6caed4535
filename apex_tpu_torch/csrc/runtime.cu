// Small runtime helpers for the ctypes bindings in ops/_build.py.
//
// The library links the CUDA runtime statically, so it keeps its own
// notion of the current device: the wrappers set it from the tensor's
// device before each launch, and turn a nonzero error code into the
// runtime's message.

#include <cuda_runtime.h>

extern "C" int apex_set_device(int device) { return (int)cudaSetDevice(device); }

extern "C" const char* apex_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
