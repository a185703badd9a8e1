from .rv32i import AddInstruction, BneInstruction, XorInstruction

__all__ = ["AddInstruction", "BneInstruction", "XorInstruction"]
