# Hand-written CUDA kernels for Hopper (sm_90a) and their plain PyTorch
# versions; `ops` dispatches by the device of the tensor it is given.
