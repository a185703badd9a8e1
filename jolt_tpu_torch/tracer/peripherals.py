"""Peripheral device models for the RV32IM tracer: a copy of
jolt_tpu/tracer/peripherals.py, behaviour for behaviour (host code;
nothing of it runs on the card).

Behavior-parity with the reference emulator's device layer
(tracer/src/emulator/device/{clint,plic,uart,virtio_block_disk}.rs —
riscv-rust heritage): a CLINT timer, a PLIC interrupt controller, an
8250-style UART, and a legacy-MMIO VirtIO block disk.  Jolt guests never
touch these (no interrupts, no MMIO — the reference's Jolt path doesn't
either); they exist so the tracer models the same machine the reference
models, and they are exercised by tests/test_peripherals.py (on
jolt_tpu's copy) and tests/test_torch_peripherals.py (on both).

Design is deliberately NOT a port: registers live as whole integers with
a generic byte-lane accessor (the reference hand-writes one match arm per
byte), and the virtqueue walk reads through a plain `Memory` protocol
(read_u8/16/32/64, write_*) instead of a wrapper hierarchy.
"""
from __future__ import annotations

from dataclasses import dataclass

# mip bits (privileged spec)
MIP_MSIP = 1 << 3
MIP_MTIP = 1 << 7
MIP_SEIP = 1 << 9
MIP_STIP = 1 << 5
MIP_SSIP = 1 << 1

VIRTIO_IRQ = 1
UART_IRQ = 10


def _get_byte(value: int, off: int) -> int:
    return (value >> (8 * off)) & 0xFF


def _set_byte(value: int, off: int, b: int, width: int) -> int:
    mask = (1 << (8 * width)) - 1
    return (value & mask & ~(0xFF << (8 * off))) | ((b & 0xFF) << (8 * off))


class Clint:
    """Core-local interruptor: msip + mtime/mtimecmp (clint.rs)."""

    BASE = 0x02000000

    def __init__(self):
        self.msip = 0
        self.mtime = 0
        self.mtimecmp = 0

    def tick(self, mip: int) -> int:
        """Advance one cycle; returns the updated mip."""
        self.mtime = (self.mtime + 1) & 0xFFFFFFFFFFFFFFFF
        if self.msip & 1:
            mip |= MIP_MSIP
        if self.mtimecmp > 0 and self.mtime >= self.mtimecmp:
            mip |= MIP_MTIP
        return mip

    # register windows: (offset, width, attr)
    _REGS = ((0x0000, 4, "msip"), (0x4000, 8, "mtimecmp"), (0xBFF8, 8, "mtime"))

    def _locate(self, address: int):
        off = address - self.BASE
        for base, width, attr in self._REGS:
            if base <= off < base + width:
                return attr, off - base, width
        return None, 0, 0

    def load(self, address: int) -> int:
        attr, off, _ = self._locate(address)
        return _get_byte(getattr(self, attr), off) if attr else 0

    def store(self, address: int, value: int) -> None:
        attr, off, width = self._locate(address)
        if attr == "msip":
            if off == 0:  # upper 31 bits hardwired to zero
                self.msip = value & 1
        elif attr:
            setattr(self, attr, _set_byte(getattr(self, attr), off, value, width))


class Plic:
    """Platform-level interrupt controller (plic.rs): per-source priority,
    pending bits, a 64-source enable word, a threshold, and claim/complete.
    Sources: VirtIO (edge-detected from its level line) and UART (edge)."""

    BASE = 0x0C000000

    def __init__(self):
        self.enabled = 0
        self.threshold = 0
        self.irq = 0
        self.priorities = [0] * 1024
        self.pending = bytearray(1024 // 8)
        self._needs_update = False
        self._virtio_level = False

    def tick(self, virtio_ip: bool, uart_ip: bool, mip: int) -> int:
        if self._virtio_level != virtio_ip:
            if virtio_ip:
                self._set_pending(VIRTIO_IRQ)
            self._virtio_level = virtio_ip
        if uart_ip:
            self._set_pending(UART_IRQ)
        if self._needs_update:
            mip = self._update_irq(mip)
            self._needs_update = False
        return mip

    def _set_pending(self, irq: int) -> None:
        self.pending[irq >> 3] |= 1 << (irq & 7)
        self._needs_update = True

    def _clear_pending(self, irq: int) -> None:
        self.pending[irq >> 3] &= ~(1 << (irq & 7)) & 0xFF
        self._needs_update = True

    def _update_irq(self, mip: int) -> int:
        best_irq, best_prio = 0, 0
        for irq in (VIRTIO_IRQ, UART_IRQ):
            ip = (self.pending[irq >> 3] >> (irq & 7)) & 1
            en = (self.enabled >> irq) & 1
            prio = self.priorities[irq]
            if ip and en and prio > self.threshold and prio > best_prio:
                best_irq, best_prio = irq, prio
        self.irq = best_irq
        if self.irq:
            mip |= MIP_SEIP
        return mip

    def load(self, address: int) -> int:
        off = address - self.BASE
        if 0x000000 <= off <= 0x000FFF:      # priorities, 4B each
            return _get_byte(self.priorities[off >> 2], off & 3)
        if 0x001000 <= off <= 0x00107F:      # pending bits
            return self.pending[off - 0x1000]
        if 0x002080 <= off <= 0x002087:      # enables (64 sources)
            return _get_byte(self.enabled, off - 0x2080)
        if 0x201000 <= off <= 0x201003:      # threshold
            return _get_byte(self.threshold, off - 0x201000)
        if 0x201004 <= off <= 0x201007:      # claim
            return _get_byte(self.irq, off - 0x201004)
        return 0

    def store(self, address: int, value: int) -> None:
        off = address - self.BASE
        if 0x000000 <= off <= 0x000FFF:
            idx = off >> 2
            self.priorities[idx] = _set_byte(self.priorities[idx], off & 3,
                                             value, 4)
            self._needs_update = True
        elif 0x002080 <= off <= 0x002087:
            self.enabled = _set_byte(self.enabled, off - 0x2080, value, 8)
            if off == 0x2080:
                self._needs_update = True
        elif 0x201000 <= off <= 0x201003:
            self.threshold = _set_byte(self.threshold, off - 0x201000,
                                       value, 4)
            if off == 0x201000:
                self._needs_update = True
        elif off == 0x201004:                # complete (byte write, as ref)
            self._clear_pending(value)


class Terminal:
    """In-memory terminal: guest output accumulates in `output`; host test
    code queues guest input via `input_queue` (terminal.rs protocol)."""

    def __init__(self):
        self.output = bytearray()
        self.input_queue = bytearray()

    def put_byte(self, b: int) -> None:
        self.output.append(b & 0xFF)

    def get_input(self) -> int:
        return self.input_queue.pop(0) if self.input_queue else 0


# UART line-status / interrupt-id bits (uart.rs:3-11)
_IER_RX = 0x1
_IER_THRE = 0x2
_IIR_THR_EMPTY = 0x2
_IIR_RD_AVAILABLE = 0x4
_IIR_NO_INTERRUPT = 0x7
_LSR_DATA_AVAILABLE = 0x1
_LSR_THR_EMPTY = 0x20

# polling cadences (uart.rs:57,71 — arbitrary in the reference too)
_UART_INPUT_PERIOD = 0x38400
_UART_OUTPUT_PERIOD = 0x10


class Uart:
    """8250-style UART (uart.rs): RBR/THR/IER/IIR/LCR/MCR/LSR/SCR at
    0x10000000, edge-triggered interrupt line."""

    BASE = 0x10000000

    def __init__(self, terminal: Terminal | None = None):
        self.terminal = terminal or Terminal()
        self.clock = 0
        self.rbr = 0
        self.thr = 0
        self.ier = 0
        self.iir = 0
        self.lcr = 0
        self.mcr = 0
        self.lsr = _LSR_THR_EMPTY
        self.scr = 0
        self._thre_ip = False
        self.interrupting = False

    def tick(self) -> None:
        self.clock = (self.clock + 1) & 0xFFFFFFFFFFFFFFFF
        rx_ip = False
        if self.clock % _UART_INPUT_PERIOD == 0 and self.rbr == 0:
            value = self.terminal.get_input()
            if value:
                self.rbr = value
                self.lsr |= _LSR_DATA_AVAILABLE
                self._update_iir()
                if self.ier & _IER_RX:
                    rx_ip = True
        if self.clock % _UART_OUTPUT_PERIOD == 0 and self.thr:
            self.terminal.put_byte(self.thr)
            self.thr = 0
            self.lsr |= _LSR_THR_EMPTY
            self._update_iir()
            if self.ier & _IER_THRE:
                self._thre_ip = True
        if self._thre_ip or rx_ip:
            self.interrupting = True
            self._thre_ip = False
        else:
            self.interrupting = False

    def _update_iir(self) -> None:
        if (self.ier & _IER_RX) and self.rbr:
            self.iir = _IIR_RD_AVAILABLE
        elif (self.ier & _IER_THRE) and not self.thr:
            self.iir = _IIR_THR_EMPTY
        else:
            self.iir = _IIR_NO_INTERRUPT

    def load(self, address: int) -> int:
        off = address - self.BASE
        dlab = (self.lcr >> 7) & 1
        if off == 0 and not dlab:
            rbr, self.rbr = self.rbr, 0
            self.lsr &= ~_LSR_DATA_AVAILABLE & 0xFF
            self._update_iir()
            return rbr
        if off == 1 and not dlab:
            return self.ier
        return {2: self.iir, 3: self.lcr, 4: self.mcr, 5: self.lsr,
                7: self.scr}.get(off, 0)

    def store(self, address: int, value: int) -> None:
        off = address - self.BASE
        dlab = (self.lcr >> 7) & 1
        if off == 0 and not dlab:
            self.thr = value & 0xFF
            self.lsr &= ~_LSR_THR_EMPTY & 0xFF
            self._update_iir()
        elif off == 1 and not dlab:
            # enabling THRE with an empty holding register fires at once
            # (driver idiom the reference also honors, uart.rs:166-171)
            if not (self.ier & _IER_THRE) and (value & _IER_THRE) \
                    and self.thr == 0:
                self._thre_ip = True
            self.ier = value & 0xFF
            self._update_iir()
        elif off == 3:
            self.lcr = value & 0xFF
        elif off == 4:
            self.mcr = value & 0xFF
        elif off == 7:
            self.scr = value & 0xFF


# virtqueue constants (virtio 1.1 legacy layout, virtio_block_disk.rs)
_VIRTQ_DESC_F_NEXT = 1
_VIRTQ_DESC_F_WRITE = 2
_SECTOR_SIZE = 512
_MAX_QUEUE_SIZE = 0x2000
_DISK_ACCESS_DELAY = 500


@dataclass
class _MmioReg:
    """A little-endian MMIO register window."""
    offset: int
    width: int
    attr: str


class VirtioBlockDisk:
    """Legacy-MMIO VirtIO block device at 0x10001000
    (virtio_block_disk.rs).  The disk image is a bytearray; a queue
    notify schedules the descriptor-chain walk _DISK_ACCESS_DELAY cycles
    later (matching the reference's modeled latency), after which the
    interrupt-status bit raises the (level-triggered) IRQ line."""

    BASE = 0x10001000

    _STORE_REGS = tuple(_MmioReg(o, w, a) for o, w, a in (
        (0x14, 4, "device_features_sel"), (0x20, 4, "driver_features"),
        (0x28, 4, "guest_page_size"), (0x30, 4, "queue_select"),
        (0x38, 4, "queue_size"), (0x3C, 4, "queue_align"),
        (0x40, 4, "queue_pfn"), (0x50, 4, "queue_notify"),
        (0x70, 4, "status")))

    def __init__(self):
        self.clock = 0
        self.device_features = 0
        self.device_features_sel = 0
        self.driver_features = 0
        self.guest_page_size = 0
        self.queue_select = 0
        self.queue_size = 0
        self.queue_align = 0x1000
        self.queue_pfn = 0
        self.queue_notify = 0
        self.interrupt_status = 0
        self.status = 0
        self.used_ring_index = 0
        self.contents = bytearray()
        self._notify_clocks: list[int] = []

    def init(self, contents: bytes) -> None:
        self.contents = bytearray(contents)

    def is_interrupting(self) -> bool:
        return bool(self.interrupt_status & 1)

    def tick(self, memory) -> None:
        if self._notify_clocks and \
                self.clock == self._notify_clocks[0] + _DISK_ACCESS_DELAY:
            self.interrupt_status |= 1
            self._handle_disk_access(memory)
            self._notify_clocks.pop(0)
        self.clock = (self.clock + 1) & 0xFFFFFFFFFFFFFFFF

    # -- registers -----------------------------------------------------------
    def load(self, address: int) -> int:
        off = address - self.BASE
        sel_feats = (self.device_features >> (self.device_features_sel * 32)
                     ) & 0xFFFFFFFF
        for base, width, value in (
                (0x00, 4, 0x74726976),       # magic "virt"
                (0x04, 4, 1),                # legacy device version
                (0x08, 4, 2),                # block device id
                (0x0C, 4, 0x554D4551),       # vendor "QEMU"
                (0x10, 4, sel_feats),
                (0x34, 4, _MAX_QUEUE_SIZE),
                (0x40, 4, self.queue_pfn),
                (0x60, 4, self.interrupt_status),
                (0x70, 4, self.status),
                (0x100, 8, 0x032000)):       # capacity config (sectors)
            if base <= off < base + width:
                return _get_byte(value, off - base)
        return 0

    def store(self, address: int, value: int) -> None:
        off = address - self.BASE
        if off == 0x64:                      # interrupt ack
            if value & 1:
                self.interrupt_status &= ~1
            return
        for reg in self._STORE_REGS:
            if reg.offset <= off < reg.offset + reg.width:
                setattr(self, reg.attr,
                        _set_byte(getattr(self, reg.attr), off - reg.offset,
                                  value, reg.width))
                if reg.attr == "queue_select" and \
                        off == reg.offset + 3 and self.queue_select:
                    raise NotImplementedError("multi-queue not supported")
                if reg.attr == "queue_notify" and off == reg.offset + 3:
                    self._notify_clocks.append(self.clock)
                return

    # -- virtqueue processing ------------------------------------------------
    def _page_address(self) -> int:
        return self.queue_pfn * self.guest_page_size

    def _desc_base(self) -> int:
        return self._page_address()

    def _avail_base(self) -> int:
        return self._desc_base() + self.queue_size * 16

    def _used_base(self) -> int:
        align = self.queue_align
        raw = self._avail_base() + 4 + self.queue_size * 2
        return (raw + align - 1) // align * align

    def _handle_disk_access(self, memory) -> None:
        """Walk one 3-descriptor chain: blk header, data, status
        (virtio_block_disk.rs:457-600)."""
        qs = self.queue_size
        head_addr = self._avail_base() + 4 + (self.used_ring_index % qs) * 2
        desc_head = memory.read_u16(head_addr) % qs

        blk_sector = 0
        desc_next = desc_head
        for desc_num in range(3):
            d = self._desc_base() + 16 * desc_next
            addr = memory.read_u64(d)
            length = memory.read_u32(d + 8)
            flags = memory.read_u16(d + 12)
            desc_next = memory.read_u16(d + 14) % qs
            if desc_num == 0:                # virtio_blk_req header
                blk_sector = memory.read_u64(addr + 8)
            elif desc_num == 1:              # data transfer
                base = blk_sector * _SECTOR_SIZE
                if base + length > len(self.contents):
                    self.contents.extend(
                        b"\x00" * (base + length - len(self.contents)))
                if flags & _VIRTQ_DESC_F_WRITE:      # device writes memory
                    for i in range(length):
                        memory.write_u8(addr + i, self.contents[base + i])
                else:                                # device reads memory
                    for i in range(length):
                        self.contents[base + i] = memory.read_u8(addr + i)
            else:                            # status byte
                assert flags & _VIRTQ_DESC_F_WRITE, \
                    "third descriptor must be device-write"
                assert length == 1, "status descriptor must be 1 byte"
                memory.write_u8(addr, 0)     # success
            if not flags & _VIRTQ_DESC_F_NEXT:
                break
        used = self._used_base()
        memory.write_u32(used + 4 + (self.used_ring_index % qs) * 8,
                         desc_head)
        self.used_ring_index = (self.used_ring_index + 1) & 0xFFFF
        memory.write_u16(used + 2, self.used_ring_index)
