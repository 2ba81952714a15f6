"""Hand-written Hopper kernels (csrc/*.cu), built with nvcc at first use and
bound with ctypes.  Importing this package builds nothing."""
