"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W limit; the run's line names the card, and PERF.md its power limit)."""
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
