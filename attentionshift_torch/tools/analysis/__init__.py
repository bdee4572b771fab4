"""Analysis tools: microbenchmarks of single layers and kernels."""
