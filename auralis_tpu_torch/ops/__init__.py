"""Signal-processing ops and the hand-written CUDA kernels of the port."""
