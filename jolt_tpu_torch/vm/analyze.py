"""Program analysis: a trace summary and per-opcode histogram
(jolt_tpu/vm/analyze.py).

Reference: jolt-core/src/host/analyze.rs: `ProgramSummary` {raw_trace,
bytecode, memory_init, io_device, processed_trace}, whose `analyze()`
counts how often each instruction ran (analyze.rs:27-44).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

from ..native import trace_native
from .host import rows_to_steps
from .rv_trace import (DEFAULT_MAX_INPUT_SIZE, DEFAULT_MAX_OUTPUT_SIZE,
                       RV32IM, JoltDevice)


@dataclass
class ProgramSummary:
    raw_trace: list            # RVTraceRow list
    bytecode: list             # BytecodeRow list
    io_device: JoltDevice
    processed_trace: list = field(default_factory=list)  # JoltTraceStep list

    def trace_len(self) -> int:
        return len(self.raw_trace)

    def analyze(self) -> list[tuple[RV32IM, int]]:
        """Per-opcode counts, most frequent first (analyze.rs:27-44)."""
        return Counter(r.instruction.opcode
                       for r in self.raw_trace).most_common()


def trace_analyze(program, vm, inputs: bytes = b"",
                  max_input_size: int = DEFAULT_MAX_INPUT_SIZE,
                  max_output_size: int = DEFAULT_MAX_OUTPUT_SIZE
                  ) -> ProgramSummary:
    """Trace a guest with the native tracer and summarize it
    (host/mod.rs:216-232)."""
    device = JoltDevice.new(max_input_size, max_output_size)
    device.inputs.extend(inputs)
    raw = trace_native(program, device)
    steps, bytecode_rows = rows_to_steps(program, raw, vm)
    return ProgramSummary(raw, bytecode_rows, device, steps)
