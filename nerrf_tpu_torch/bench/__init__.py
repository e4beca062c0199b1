"""Model-FLOP counting and MFU: the port of ``nerrf_tpu/bench/flops.py``
and ``nerrf_tpu/bench/mfu.py``."""
