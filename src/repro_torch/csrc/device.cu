// What the device reports about its own launch limits, for the callers
// that hold a launch plan against the card it runs on (the kernels' plans
// are proven against Hopper's documented limits in kernels/limits.py).

#include <cuda_runtime.h>

// The launch limits of device `device`'s grid, as the device reports them
// (cudaDevAttrMaxGridDim{X,Y,Z}), into xyz[0..2].  Returns the CUDA error
// code (0 = success).
extern "C" int fastcaps_grid_limits(int device, int* xyz) {
  const cudaDeviceAttr attrs[3] = {cudaDevAttrMaxGridDimX,
                                   cudaDevAttrMaxGridDimY,
                                   cudaDevAttrMaxGridDimZ};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = cudaDeviceGetAttribute(&xyz[i], attrs[i], device);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
