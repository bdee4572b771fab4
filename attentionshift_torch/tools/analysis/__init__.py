"""Analysis tools: microbenchmarks of single layers and kernels, and the
best and worst evaluated images (``analyze_results``)."""
