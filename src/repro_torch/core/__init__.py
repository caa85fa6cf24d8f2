"""Digit arithmetic: schedules, quantization, the L2R GEMM schedules."""
