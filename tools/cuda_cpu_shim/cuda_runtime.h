// Stands in for the CUDA runtime header when a kernel source is compiled
// with g++ by tools/cuda_cpu_shim/rehearse.py.
#pragma once
#include "shim.h"
