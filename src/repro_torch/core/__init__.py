"""Precision policies, epilogues, tiling and the GEMM engine."""
