"""Core library: quantization, the exact GEMM designs and their pricing.

- quantization  : INT2/4/8 symmetric quantization
- packing       : int2/4/8 codes packed into int32-word weight stores
- unary         : temporal, 2-unary and rate-coded stream encodings
- gemm_sims     : functional GEMMs, stream simulators and cycle models for
                  the paper's four units (uGEMM's exact slot counts included)
- ppa           : calibrated Nangate45 PPA model (paper Tables I-IV)
- sparsity      : word/bit sparsity profiling (Table V, Eq. 1)
- accounting    : end-to-end DLA energy/latency pricing of model workloads
"""
