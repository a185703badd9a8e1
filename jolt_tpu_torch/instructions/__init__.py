from .rv32i import XorInstruction

__all__ = ["XorInstruction"]
