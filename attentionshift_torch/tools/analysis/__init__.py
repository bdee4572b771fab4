"""Analysis tools: microbenchmarks of single layers and kernels, the best
and worst evaluated images (``analyze_results``), the metrics of a dump
(``eval_metric``) and the learning check on synthetic blobs
(``learning_check``)."""
