"""System bus + MMU for the RV32IM tracer machine model: a copy of
jolt_tpu/tracer/bus.py, behaviour for behaviour (host code; nothing of it
runs on the card).

Behavior-parity with the reference emulator's Mmu (tracer/src/emulator/
mmu.rs — riscv-rust heritage): physical address routing to DRAM /
CLINT / PLIC / UART / VirtIO / JoltDevice windows, SV32/SV39 virtual
address translation with A/D-bit write-back and optional per-access page
caches, mstatus.MPRV handling, and the per-cycle peripheral tick.

Jolt guests run machine-mode with translation off (the reference's Jolt
path never enables satp either); this module exists so the tracer models
the same machine, and it is exercised by tests/test_peripherals.py (on
jolt_tpu's copy) and tests/test_torch_peripherals.py (on both).

Design is deliberately NOT a port: the physical map is one routing table
(the reference hand-writes match arms per access width), translation is
an iterative walk driven by per-mode (levels, vpn-split, pte-size)
parameters instead of duplicated SV32/SV39 recursion, and faults are
Python exceptions (`PageFault`) rather than Result<_, Trap> plumbing.
"""
from __future__ import annotations

from ..vm.rv_trace import RAM_START_ADDRESS, JoltDevice
from .peripherals import Clint, Plic, Terminal, Uart, VirtioBlockDisk

DRAM_BASE = RAM_START_ADDRESS  # 0x8000_0000 (mmu.rs DRAM_BASE)

# privilege modes (encoded as in the privileged spec / cpu.rs)
USER, SUPERVISOR, RESERVED, MACHINE = 0, 1, 2, 3

EXECUTE, READ, WRITE, DONT_CARE = "x", "r", "w", "-"

# addressing modes: name -> (levels, pte_bytes, vpn_bits, ppn_bits)
# vpn/ppn splits are LSB-first per level (satp spec; mmu.rs:873-1000).
_MODES = {
    "sv32": (2, 4, (10, 10), (10, 12)),
    "sv39": (3, 8, (9, 9, 9), (9, 9, 26)),
}
PAGE_SIZE = 4096


class PageFault(Exception):
    """Raised on a failed translation; `kind` is the access type."""

    def __init__(self, kind: str, address: int):
        super().__init__(f"page fault ({kind}) at {address:#x}")
        self.kind = kind
        self.address = address


class Dram:
    """Flat little-endian RAM at DRAM_BASE (memory.rs MemoryWrapper)."""

    def __init__(self, capacity: int = 1 << 24):
        self.data = bytearray(capacity)

    def _off(self, address: int, n: int) -> int:
        off = address - DRAM_BASE
        if off + n > len(self.data):  # grow on demand (tests, disk DMA)
            self.data.extend(b"\x00" * (off + n - len(self.data)))
        return off

    def read(self, address: int, n: int) -> int:
        off = self._off(address, n)
        return int.from_bytes(self.data[off:off + n], "little")

    def write(self, address: int, value: int, n: int) -> None:
        off = self._off(address, n)
        self.data[off:off + n] = (value & ((1 << (8 * n)) - 1)
                                  ).to_bytes(n, "little")

    def validate_address(self, address: int) -> bool:
        return 0 <= address - DRAM_BASE < len(self.data)


class _DmaView:
    """Physical-address accessor protocol handed to the VirtIO queue walk
    (read_u8/16/32/64, write_u8/16/32): descriptor chains hold physical
    DRAM pointers, so DMA bypasses translation (mmu.rs MemoryWrapper)."""

    def __init__(self, bus: "SystemBus"):
        self._bus = bus

    def __getattr__(self, name: str):
        kind, _, width = name.partition("_u")
        n = int(width) // 8
        if kind == "read":
            return lambda a: self._bus.load_phys(a, n)
        return lambda a, v: self._bus.store_phys(a, v, n)


class SystemBus:
    """Physical routing + virtual translation (mmu.rs Mmu; "It may also
    be said Bus")."""

    def __init__(self, jolt_device: JoltDevice | None = None,
                 terminal: Terminal | None = None, xlen: int = 32):
        self.xlen = xlen
        self.dram = Dram()
        self.clint = Clint()
        self.plic = Plic()
        self.uart = Uart(terminal)
        self.disk = VirtioBlockDisk()
        self.jolt_device = jolt_device or JoltDevice.new()
        self.mip = 0
        # translation state (updated from csr writes by a system emulator)
        self.addressing_mode: str | None = None  # None / "sv32" / "sv39"
        self.privilege_mode = MACHINE
        self.ppn = 0
        self.mstatus = 0
        self.page_cache_enabled = False
        self._page_cache: dict[str, dict[int, int]] = \
            {EXECUTE: {}, READ: {}, WRITE: {}}
        self._dma = _DmaView(self)
        # MMIO windows, checked in order (mmu.rs:489-512,634-656)
        self._mmio = ((Clint.BASE, Clint.BASE + 0x10000, self.clint),
                      (Plic.BASE, 0x10000000, self.plic),
                      (Uart.BASE, Uart.BASE + 0x100, self.uart),
                      (VirtioBlockDisk.BASE,
                       VirtioBlockDisk.BASE + 0x1000, self.disk))

    # -- clocking ------------------------------------------------------------
    def tick(self) -> None:
        """One machine cycle: clint -> disk DMA -> uart -> plic
        (mmu.rs:178-188); interrupt lines accumulate into self.mip."""
        self.mip = self.clint.tick(self.mip)
        self.disk.tick(self._dma)
        self.uart.tick()
        self.mip = self.plic.tick(self.disk.is_interrupting(),
                                  self.uart.interrupting, self.mip)

    # -- translation-state updates (clear caches like mmu.rs:194-226) --------
    def update_addressing_mode(self, mode: str | None) -> None:
        if mode == "sv48":
            # stub parity: the reference panics "SV48 is not supported
            # yet" (mmu.rs:70, 843-845)
            raise NotImplementedError("AddressingMode SV48 is not supported")
        assert mode in (None, "sv32", "sv39"), f"unsupported mode {mode}"
        self.addressing_mode = mode
        self._clear_page_cache()

    def update_privilege_mode(self, mode: int) -> None:
        self.privilege_mode = mode
        self._clear_page_cache()

    def update_ppn(self, ppn: int) -> None:
        self.ppn = ppn
        self._clear_page_cache()

    def update_mstatus(self, mstatus: int) -> None:
        self.mstatus = mstatus

    def enable_page_cache(self, enabled: bool) -> None:
        self.page_cache_enabled = enabled
        self._clear_page_cache()

    def _clear_page_cache(self) -> None:
        for c in self._page_cache.values():
            c.clear()

    # -- physical accesses ----------------------------------------------------
    def _effective(self, address: int) -> int:
        return address & 0xFFFFFFFF if self.xlen == 32 else address

    def load_phys(self, p_address: int, n: int = 1) -> int:
        a = self._effective(p_address)
        if a >= DRAM_BASE:
            return self.dram.read(a, n)
        for lo, hi, dev in self._mmio:
            if lo <= a < hi:
                return sum(dev.load(a + i) << (8 * i) for i in range(n))
        if self.jolt_device.is_input(a):
            return sum(self.jolt_device.load(a + i) << (8 * i)
                       for i in range(n))
        raise RuntimeError(f"unknown memory mapping {a:#x}")

    def store_phys(self, p_address: int, value: int, n: int = 1) -> None:
        a = self._effective(p_address)
        if a >= DRAM_BASE:
            self.dram.write(a, value, n)
            return
        for lo, hi, dev in self._mmio:
            if lo <= a < hi:
                for i in range(n):
                    dev.store(a + i, (value >> (8 * i)) & 0xFF)
                return
        if self.jolt_device.is_output(a) or self.jolt_device.is_panic(a):
            for i in range(n):
                self.jolt_device.store(a + i, (value >> (8 * i)) & 0xFF)
            return
        raise RuntimeError(f"unknown memory mapping {a:#x}")

    # -- virtual accesses ------------------------------------------------------
    def fetch_word(self, v_address: int) -> int:
        p = self.translate(v_address, EXECUTE)
        return self.load_phys(p, 4)

    def load(self, v_address: int, n: int = 1) -> int:
        p = self.translate(v_address, READ)
        return self.load_phys(p, n)

    def store(self, v_address: int, value: int, n: int = 1) -> None:
        p = self.translate(v_address, WRITE)
        self.store_phys(p, value, n)

    def validate_address(self, v_address: int) -> bool:
        a = self._effective(self.translate(v_address, DONT_CARE))
        if a >= DRAM_BASE:
            return self.dram.validate_address(a)
        return any(lo <= a < hi for lo, hi, _ in self._mmio)

    # -- translation (mmu.rs:755-1000) -----------------------------------------
    def translate(self, v_address: int, access: str) -> int:
        address = self._effective(v_address)
        if self.addressing_mode is None:
            return address
        cache = self._page_cache.get(access) \
            if self.page_cache_enabled else None
        if cache is not None and (address & ~0xFFF) in cache:
            return cache[address & ~0xFFF] | (address & 0xFFF)

        priv = self.privilege_mode
        if priv == MACHINE:
            # machine mode translates only when mstatus.MPRV re-points
            # data accesses at MPP's mode (mmu.rs:778-806)
            if access == EXECUTE or not (self.mstatus >> 17) & 1:
                return address
            mpp = (self.mstatus >> 9) & 3
            if mpp == MACHINE:
                return address
            priv = mpp
        if priv == RESERVED:
            return address

        p_address = self._walk(address, access)
        if cache is not None:
            cache[address & ~0xFFF] = p_address & ~0xFFF
        return p_address

    def _walk(self, address: int, access: str) -> int:
        """Iterative page-table walk with A/D write-back and superpage
        alignment checks (mmu.rs traverse_page)."""
        mode = self.addressing_mode
        levels, pte_size, vpn_bits, ppn_bits = _MODES[mode]
        vpns, shift = [], 12
        for bits in vpn_bits:
            vpns.append((address >> shift) & ((1 << bits) - 1))
            shift += bits

        parent_ppn = self.ppn
        for level in range(levels - 1, -1, -1):
            pte_address = parent_ppn * PAGE_SIZE + vpns[level] * pte_size
            pte = self.load_phys(pte_address, pte_size)
            d, a = (pte >> 7) & 1, (pte >> 6) & 1
            x, w, r, v = (pte >> 3) & 1, (pte >> 2) & 1, (pte >> 1) & 1, pte & 1
            if v == 0 or (r == 0 and w == 1):
                raise PageFault(access, address)
            ppns, shift = [], 10
            for bits in ppn_bits:
                ppns.append((pte >> shift) & ((1 << bits) - 1))
                shift += bits
            if r == 0 and x == 0:  # pointer to next level
                if level == 0:
                    raise PageFault(access, address)
                parent_ppn = (pte >> 10) & ((1 << sum(ppn_bits)) - 1)
                continue
            # leaf: set A (always) and D (on write) before permission
            # checks, as the reference does (mmu.rs:927-946)
            if a == 0 or (access == WRITE and d == 0):
                new_pte = pte | (1 << 6) | ((1 << 7) if access == WRITE else 0)
                self.store_phys(pte_address, new_pte, pte_size)
            if (access == EXECUTE and x == 0) or \
                    (access == READ and r == 0) or \
                    (access == WRITE and w == 0):
                raise PageFault(access, address)
            if any(ppns[i] for i in range(level)):  # misaligned superpage
                raise PageFault(access, address)
            # physical: high PPN fields from the PTE, low from the VPN
            p, shift = address & 0xFFF, 12
            for i in range(levels):
                part = ppns[i] if i >= level else vpns[i]
                p |= part << shift
                shift += vpn_bits[i] if i < levels - 1 else ppn_bits[i]
            return p
        raise PageFault(access, address)
