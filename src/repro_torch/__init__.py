"""PyTorch port of the SIMD-X reproduction, for NVIDIA Hopper (sm_90a).

Mirrors the layout of the JAX package `repro` module for module:

  graph/    -- CSR structure, seeded generators, degree-bucketed ELL packing
  core/     -- the ACC model, JIT filters, the program catalog, the solo
               push-pull engine
  kernels/  -- hand-written CUDA kernels (sources in csrc/) with their plain
               PyTorch versions and a device dispatcher
  nn/, models/, configs/
            -- transformer layers and MoE, the model stacks' forward and
               serving paths (transformer, DeepFM, GNNs, DimeNet) and the
               assigned-architecture registry
  interop   -- numpy arrays of the reference package -> this package's tensors

Entry points that create tensors take `device=` (default "cuda"); a CUDA
request on a machine without a GPU raises instead of running on the CPU.
"""

from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
