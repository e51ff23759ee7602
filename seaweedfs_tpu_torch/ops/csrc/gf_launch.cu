// Host side of the per-matrix GF(2^8) kernels (csrc/gf_bitslice.cu): loads
// a compiled image with cudaLibraryLoadData and launches its kernel on a
// caller's stream.  Built with nvcc into a shared library with a plain C
// interface (ops/_build.py) and called through ctypes from ops/rs_cuda.py.
// Holds no kernel of its own.  This library links its own CUDA runtime,
// whose current device is per thread and independent of PyTorch's, so
// every entry sets the device first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 16;
constexpr int kMaxSrcs = 16;
constexpr int kThreads = 256;  // GF_THREADS of the template
constexpr long long kTile = 2 * 16 * kThreads;  // GF_TILE of the template

}  // namespace

// image: a cubin for this library's device; name: its kernel's name.  On
// success *library and *kernel hold the handles.  Returns a cudaError_t.
extern "C" int gf_bs_load(const void* image, const char* name, int device,
                          void** library, void** kernel) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaLibrary_t lib = nullptr;
  err = cudaLibraryLoadData(&lib, image, nullptr, nullptr, 0, nullptr,
                            nullptr, 0);
  if (err != cudaSuccess) return (int)err;
  cudaKernel_t k = nullptr;
  err = cudaLibraryGetKernel(&k, lib, name);
  if (err != cudaSuccess) {
    cudaLibraryUnload(lib);
    return (int)err;
  }
  *library = lib;
  *kernel = (void*)k;
  return 0;
}

// Waits for the device's work, then unloads a library from gf_bs_load.
extern "C" int gf_bs_unload(void* library, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaLibraryUnload((cudaLibrary_t)library);
}

// kernel: from gf_bs_load, built for an (rows, srcs) matrix.  in/out:
// device pointers on CUDA device `device`; entry v's input row j starts at
// in + v*in_bstride + j*in_stride, its output row i at
// out + v*out_bstride + i*out_stride; B columns each, V entries.  Input
// entries may overlap (a sweep over shifted windows); output rows and
// entries may not.  Launches on `stream` and returns the launch's
// cudaError_t (0 on success); B == 0 or V == 0 launches nothing.
extern "C" int gf_bs_launch(void* kernel, int rows, int srcs, const void* in,
                            long long in_stride, long long in_bstride,
                            void* out, long long out_stride,
                            long long out_bstride, long long B, long long V,
                            int device, void* stream) {
  if (rows < 1 || rows > kMaxRows || srcs < 1 || srcs > kMaxSrcs || B < 0 ||
      V < 0 || in_bstride < 0 || (srcs > 1 && in_stride < B) ||
      (rows > 1 && out_stride < B) ||
      (V > 1 && out_bstride < (rows - 1) * out_stride + B))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || V == 0) return 0;
  const long long blocks = (B + kTile - 1) / kTile;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const unsigned long long align =
      (unsigned long long)(uintptr_t)in | (unsigned long long)in_stride |
      (unsigned long long)in_bstride | (unsigned long long)(uintptr_t)out |
      (unsigned long long)out_stride | (unsigned long long)out_bstride;
  int mode = (align & 15ull) == 0 ? 2 : (align & 3ull) == 0 ? 1 : 0;
  const dim3 grid((unsigned)blocks, (unsigned)(V < 65535 ? V : 65535));
  void* args[] = {&in, &in_stride, &in_bstride, &out, &out_stride,
                  &out_bstride, &B, &V, &mode};
  const cudaError_t err =
      cudaLaunchKernel((const void*)kernel, grid, dim3(kThreads), args, 0,
                       static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
