"""The multi-device prover (jolt_tpu/parallel)."""
