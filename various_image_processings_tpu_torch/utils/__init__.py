"""Image I/O and CUDA-event timing."""
