"""jolt_tpu_torch: the PyTorch/CUDA port of jolt_tpu, for one NVIDIA H100.

The JAX package `jolt_tpu` is the reference; this package imports nothing
of it (nor JAX) and keeps its own copies of the host code it needs.  Field
elements keep jolt_tpu's layout at every public function: int32 tensors of
sixteen 16-bit limbs, limbs first, Montgomery form with R = 2^256.  Entry
points run on the CUDA card unless the caller passes device="cpu".
"""
