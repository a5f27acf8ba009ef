// Common helpers for the port's native (host-side) mesh modules.
//
// These C++ modules replace the reference's native wheel dependencies:
// skimage marching_cubes, sklearn KDTree, open3d TSDF fusion, pyrender
// depth rasterization. They are the JAX package's `native/src` sources
// (less its EXR codec), kept here so that the port builds its own copy;
// everything here is host-side mesh/metric tooling.
#pragma once

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
// All output buffers are malloc'd by the library and must be released
// with i2sdf_free.
void i2sdf_free(void* p);
}

inline float* copy_out(const std::vector<float>& v) {
  float* p = static_cast<float*>(std::malloc(v.size() * sizeof(float)));
  std::memcpy(p, v.data(), v.size() * sizeof(float));
  return p;
}

inline int32_t* copy_out(const std::vector<int32_t>& v) {
  int32_t* p = static_cast<int32_t*>(std::malloc(v.size() * sizeof(int32_t)));
  std::memcpy(p, v.data(), v.size() * sizeof(int32_t));
  return p;
}
