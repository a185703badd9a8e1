"""The EVM verifier path: fixture generators, the Solidity-subset VM and
the R1CSMatrix.sol generator (jolt_tpu/evm/; reference:
jolt-evm-verifier)."""
