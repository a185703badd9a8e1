"""The port's tracer machine model (tracer/bus.py, tracer/peripherals.py)
against jolt_tpu's.

Each of tests/test_peripherals.py's ten scenarios runs on both packages'
classes, keeps its own assertions, and records every observable: the
values loads return, `mip` after each tick, DRAM bytes, the terminal's
output, the JoltDevice's outputs, and each fault's kind and address.  The
two records must be equal.  A seeded differential run then drives both
buses with the same random sequence (numpy.random.default_rng) of loads
and stores of every width over DRAM, CLINT, PLIC, UART, the VirtIO disk
and the JoltDevice window, with ticks between them, and SV32/SV39 walks
over random page tables under every privilege mode, MPRV and the page
cache.  Host code only: no torch, no JAX program.
"""
from types import SimpleNamespace

import numpy as np
import pytest

from jolt_tpu.tracer import bus as jbus
from jolt_tpu.tracer import peripherals as jper
from jolt_tpu.vm import rv_trace as jrv
from jolt_tpu_torch.tracer import bus as pbus
from jolt_tpu_torch.tracer import peripherals as pper
from jolt_tpu_torch.vm import rv_trace as prv

NAMES_BUS = ("DRAM_BASE", "MACHINE", "PAGE_SIZE", "SUPERVISOR", "USER",
             "PageFault", "SystemBus")
NAMES_PER = ("MIP_MSIP", "MIP_MTIP", "MIP_SEIP", "UART_IRQ", "VIRTIO_IRQ",
             "Clint", "Plic", "Terminal", "Uart", "VirtioBlockDisk",
             "_UART_INPUT_PERIOD")


def _pkg(bus_mod, per_mod, rv_mod) -> SimpleNamespace:
    ns = {n: getattr(bus_mod, n) for n in NAMES_BUS}
    ns.update({n: getattr(per_mod, n) for n in NAMES_PER})
    ns["JoltDevice"] = rv_mod.JoltDevice
    return SimpleNamespace(**ns)


JAX_PKG = _pkg(jbus, jper, jrv)
PORT_PKG = _pkg(pbus, pper, prv)


def test_the_port_keeps_jolt_tpus_names_and_constants():
    for name in NAMES_BUS + NAMES_PER:
        a, b = getattr(JAX_PKG, name), getattr(PORT_PKG, name)
        if isinstance(a, int):
            assert a == b, name
        else:
            assert a.__name__ == b.__name__, name
            assert a.__module__.startswith("jolt_tpu.")
            assert b.__module__.startswith("jolt_tpu_torch.")
    for cls in ("Clint", "Plic", "Uart", "VirtioBlockDisk"):
        assert getattr(JAX_PKG, cls).BASE == getattr(PORT_PKG, cls).BASE


class Record(list):
    """The observables of one run."""

    def call(self, fn, *args):
        """fn(*args), recording its result, or its fault's kind and
        address (PageFault) or message (RuntimeError)."""
        try:
            out = fn(*args)
        except Exception as e:           # noqa: BLE001 - recorded
            if type(e).__name__ == "PageFault":
                self.append(("PageFault", e.kind, e.address))
            else:
                self.append((type(e).__name__, str(e)))
            return e
        self.append(("ok", out))
        return out


def _snapshot(bus) -> tuple:
    return (bus.mip, bytes(bus.dram.data), bytes(bus.uart.terminal.output),
            bytes(bus.jolt_device.outputs), bool(bus.jolt_device.panic),
            bytes(bus.disk.contents))


# ---------------------------------------------------------------------------
# tests/test_peripherals.py's ten scenarios, on either package
# ---------------------------------------------------------------------------

def clint_timer_and_software_interrupt(m, rec):
    bus = m.SystemBus()
    bus.store_phys(m.Clint.BASE + 0x4000, 5, 8)
    for _ in range(4):
        bus.tick()
        rec.append(bus.mip)
    assert not bus.mip & m.MIP_MTIP
    bus.tick()
    assert bus.mip & m.MIP_MTIP
    assert rec.call(bus.load_phys, m.Clint.BASE + 0xBFF8, 8) == 5
    bus.store_phys(m.Clint.BASE, 0xFF, 4)
    assert rec.call(bus.load_phys, m.Clint.BASE, 4) == 1
    bus.tick()
    assert bus.mip & m.MIP_MSIP
    rec.append(_snapshot(bus))


def uart_tx_reaches_terminal_and_interrupts_via_plic(m, rec):
    bus = m.SystemBus()
    bus.store_phys(m.Plic.BASE + 4 * m.UART_IRQ, 7, 4)
    bus.store_phys(m.Plic.BASE + 0x2080, 1 << m.UART_IRQ, 4)
    bus.store_phys(m.Plic.BASE + 0x201000, 0, 4)
    bus.store_phys(m.Uart.BASE + 1, 0x2, 1)
    bus.store_phys(m.Uart.BASE, ord("J"), 1)
    for _ in range(0x11):
        bus.tick()
        rec.append(bus.mip)
    assert bytes(bus.uart.terminal.output) == b"J"
    bus.tick()
    assert bus.mip & m.MIP_SEIP
    assert rec.call(bus.load_phys, m.Plic.BASE + 0x201004, 4) == m.UART_IRQ
    bus.store_phys(m.Plic.BASE + 0x201004, m.UART_IRQ, 1)
    bus.tick()
    assert bus.plic.irq == 0
    rec.append(_snapshot(bus))


def uart_rx_read_clears_data_ready(m, rec):
    term = m.Terminal()
    term.input_queue.extend(b"hi")
    bus = m.SystemBus(terminal=term)
    bus.uart.clock = m._UART_INPUT_PERIOD - 1
    bus.tick()
    assert bus.uart.lsr & 0x1
    assert rec.call(bus.load_phys, m.Uart.BASE, 1) == ord("h")
    assert not bus.uart.lsr & 0x1
    rec.append((bus.uart.lsr, _snapshot(bus)))


def plic_threshold_masks_low_priority(m, rec):
    plic = m.Plic()
    plic.priorities[m.VIRTIO_IRQ] = 1
    plic.enabled = 1 << m.VIRTIO_IRQ
    plic.threshold = 3
    mip = plic.tick(True, False, 0)
    assert not mip & m.MIP_SEIP and plic.irq == 0
    rec.append((mip, plic.irq))
    plic.threshold = 0
    plic._needs_update = True
    mip = plic.tick(True, False, 0)
    assert mip & m.MIP_SEIP and plic.irq == m.VIRTIO_IRQ
    rec.append((mip, plic.irq))


def _virtio_request(m, bus, rec, sector, data_addr, length, write_to_memory):
    page = 0x80100000
    base = m.VirtioBlockDisk.BASE
    bus.store_phys(base + 0x28, m.PAGE_SIZE, 4)
    bus.store_phys(base + 0x38, 4, 4)
    bus.store_phys(base + 0x3C, m.PAGE_SIZE, 4)
    bus.store_phys(base + 0x40, page // m.PAGE_SIZE, 4)
    head_addr = page + 0x200
    bus.store_phys(head_addr + 8, sector, 8)
    status_addr = page + 0x300
    descs = ((head_addr, 16, 0x1, 1),
             (data_addr, length, (0x2 if write_to_memory else 0) | 0x1, 2),
             (status_addr, 1, 0x2, 0))
    for i, (addr, dlen, flags, nxt) in enumerate(descs):
        d = page + 16 * i
        bus.store_phys(d, addr, 8)
        bus.store_phys(d + 8, dlen, 4)
        bus.store_phys(d + 12, flags, 2)
        bus.store_phys(d + 14, nxt, 2)
    avail = page + 4 * 16
    used_before = bus.disk.used_ring_index
    bus.store_phys(avail + 4 + (used_before % 4) * 2, 0, 2)
    bus.store_phys(base + 0x50, 0, 4)
    for _ in range(502):
        bus.tick()
    assert rec.call(bus.load_phys, status_addr, 1) == 0


def virtio_disk_read_and_write_roundtrip(m, rec):
    bus = m.SystemBus()
    bus.disk.init(bytes(range(256)) * 8)
    data = 0x80200000
    _virtio_request(m, bus, rec, 1, data, 16, True)
    assert rec.call(bus.load_phys, data, 8) == int.from_bytes(
        bytes(range(0, 8)), "little")
    assert bus.mip & m.MIP_SEIP == 0
    assert bus.disk.is_interrupting()
    assert bus.disk.used_ring_index == 1
    bus.store_phys(m.VirtioBlockDisk.BASE + 0x64, 1, 4)
    assert not bus.disk.is_interrupting()
    bus.store_phys(data, 0xDEADBEEF, 4)
    _virtio_request(m, bus, rec, 1, data, 4, False)
    assert bus.disk.contents[512:516] == (0xDEADBEEF).to_bytes(4, "little")
    rec.append((bus.disk.used_ring_index, _snapshot(bus)))


def _write_pte(bus, table, index, ppn, flags, pte_size=4):
    bus.store_phys(table + index * pte_size, (ppn << 10) | flags, pte_size)


def sv32_two_level_walk_sets_ad_bits(m, rec):
    bus = m.SystemBus()
    root, leaf_table = m.DRAM_BASE + 0x4000, m.DRAM_BASE + 0x5000
    frame, va = m.DRAM_BASE + 0x6000, 0x0040_2000
    _write_pte(bus, root, 1, leaf_table >> 12, 0x1)
    _write_pte(bus, leaf_table, 2, frame >> 12, 0x7)
    bus.update_addressing_mode("sv32")
    bus.update_ppn(root >> 12)
    bus.update_privilege_mode(m.SUPERVISOR)
    bus.store_phys(frame + 0x34, 0xCAFE, 4)
    assert rec.call(bus.load, va + 0x34, 4) == 0xCAFE
    pte = rec.call(bus.load_phys, leaf_table + 2 * 4, 4)
    assert pte & (1 << 6) and not pte & (1 << 7)
    rec.call(bus.store, va + 0x38, 77, 4)
    assert rec.call(bus.load_phys, frame + 0x38, 4) == 77
    assert rec.call(bus.load_phys, leaf_table + 2 * 4, 4) & (1 << 7)
    assert isinstance(rec.call(bus.fetch_word, va), m.PageFault)
    assert isinstance(rec.call(bus.load, 0x0080_0000, 4), m.PageFault)
    rec.append(_snapshot(bus))


def sv32_superpage_and_misalignment_fault(m, rec):
    bus = m.SystemBus()
    root = m.DRAM_BASE + 0x4000
    bus.update_addressing_mode("sv32")
    bus.update_ppn(root >> 12)
    bus.update_privilege_mode(m.SUPERVISOR)
    _write_pte(bus, root, 0x200, 0x200 << 10, 0xF)
    bus.store_phys(m.DRAM_BASE + 0x1234, 0xAB, 1)
    assert rec.call(bus.load, 0x8000_1234, 1) == 0xAB
    assert rec.call(bus.fetch_word, 0x8000_1234) == \
        rec.call(bus.load_phys, m.DRAM_BASE + 0x1234, 4)
    _write_pte(bus, root, 0x201, (0x200 << 10) | 3, 0xF)
    assert isinstance(rec.call(bus.load, 0x8040_0000, 1), m.PageFault)
    rec.append(_snapshot(bus))


def sv39_translation_4k_page(m, rec):
    bus = m.SystemBus(xlen=64)
    root, mid = m.DRAM_BASE + 0x10000, m.DRAM_BASE + 0x11000
    leaf, frame = m.DRAM_BASE + 0x12000, m.DRAM_BASE + 0x13000
    va = (3 << 30) | (5 << 21) | (7 << 12)
    _write_pte(bus, root, 3, mid >> 12, 0x1, 8)
    _write_pte(bus, mid, 5, leaf >> 12, 0x1, 8)
    _write_pte(bus, leaf, 7, frame >> 12, 0xF, 8)
    bus.update_addressing_mode("sv39")
    bus.update_ppn(root >> 12)
    bus.update_privilege_mode(m.SUPERVISOR)
    rec.call(bus.store, va + 8, 0x1122334455667788, 8)
    assert rec.call(bus.load_phys, frame + 8, 8) == 0x1122334455667788
    bus.enable_page_cache(True)
    assert rec.call(bus.load, va + 8, 8) == 0x1122334455667788
    assert rec.call(bus.load, va + 8, 8) == 0x1122334455667788
    rec.append(_snapshot(bus))


def machine_mode_mprv_redirects_data_not_fetch(m, rec):
    bus = m.SystemBus()
    root, frame = m.DRAM_BASE + 0x4000, m.DRAM_BASE + 0x7000
    leaf_table = m.DRAM_BASE
    _write_pte(bus, root, 0, leaf_table >> 12, 0x1)
    _write_pte(bus, leaf_table, 3, frame >> 12, 0x7)
    bus.update_addressing_mode("sv32")
    bus.update_ppn(root >> 12)
    bus.update_privilege_mode(m.MACHINE)
    bus.update_mstatus((1 << 17) | (m.SUPERVISOR << 9))
    bus.store_phys(frame, 99, 4)
    assert rec.call(bus.load, 0x3000, 4) == 99
    bus.store_phys(m.DRAM_BASE + 0x3000, 0x13, 4)
    assert rec.call(bus.fetch_word, 0x8000_3000) == 0x13
    bus.update_mstatus(0)
    assert isinstance(rec.call(bus.load, 0x3000, 4), RuntimeError)
    rec.append(_snapshot(bus))


def jolt_device_window_via_bus(m, rec):
    dev = m.JoltDevice.new()
    dev.inputs.extend(b"\x11\x22\x33\x44")
    bus = m.SystemBus(jolt_device=dev)
    a = dev.memory_layout.input_start
    assert rec.call(bus.load_phys, a, 4) == 0x44332211
    bus.store_phys(dev.memory_layout.output_start, 0xAA, 1)
    assert bytes(dev.outputs)[:1] == b"\xaa"
    rec.append(_snapshot(bus))


SCENARIOS = (clint_timer_and_software_interrupt,
             uart_tx_reaches_terminal_and_interrupts_via_plic,
             uart_rx_read_clears_data_ready,
             plic_threshold_masks_low_priority,
             virtio_disk_read_and_write_roundtrip,
             sv32_two_level_walk_sets_ad_bits,
             sv32_superpage_and_misalignment_fault,
             sv39_translation_4k_page,
             machine_mode_mprv_redirects_data_not_fetch,
             jolt_device_window_via_bus)


def _run(scenario, m) -> Record:
    rec = Record()
    scenario(m, rec)
    return rec


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_observables_equal_jolt_tpus(scenario):
    got, want = _run(scenario, PORT_PKG), _run(scenario, JAX_PKG)
    assert len(got) == len(want) > 0
    assert got == want


# ---------------------------------------------------------------------------
# the seeded differential run
# ---------------------------------------------------------------------------

def _mmio_script(seed: int, n_ops: int) -> list:
    """A random sequence of (op, window, offset, width, value) over every
    physical window; the VirtIO queue-notify register stays out (a random
    descriptor chain could ask the DRAM model to grow without bound)."""
    rng = np.random.default_rng(seed)
    windows = ("dram", "clint", "plic", "uart", "virtio", "jolt_in",
               "jolt_out", "unmapped")
    ops = []
    for _ in range(n_ops):
        kind = ("load", "store", "tick")[rng.integers(0, 3)]
        win = windows[rng.integers(0, len(windows))]
        width = int((1, 2, 4, 8)[rng.integers(0, 4)])
        value = int(rng.integers(0, 1 << 63, dtype=np.uint64)) \
            | (int(rng.integers(0, 2)) << 63)
        off = int(rng.integers(0, 1 << 16))
        ops.append((kind, win, off, width, value,
                    int(rng.integers(1, 40))))
    return ops


def _window_address(m, bus, win: str, off: int) -> int:
    layout = bus.jolt_device.memory_layout
    if win == "dram":
        return m.DRAM_BASE + off
    if win == "clint":
        return m.Clint.BASE + (0, 0x4000, 0xBFF8, off & 0xFFF8)[off % 4] \
            + (off >> 8) % 8
    if win == "plic":
        return m.Plic.BASE + (4 * (off % 32), 0x1000 + off % 8,
                              0x2080 + off % 8, 0x201000,
                              0x201004 + off % 4)[off % 5]
    if win == "uart":
        return m.Uart.BASE + off % 8
    if win == "virtio":
        reg = off % 0x100
        return m.VirtioBlockDisk.BASE + (reg if not 0x50 <= reg < 0x54
                                         else reg + 0x10)
    if win == "jolt_in":
        return layout.input_start + off % 48
    if win == "jolt_out":
        return layout.output_start + off % (layout.panic
                                            - layout.output_start + 1)
    return 0x1000 + off


def _mmio_run(m, seed: int, n_ops: int) -> Record:
    term = m.Terminal()
    term.input_queue.extend(bytes(range(32, 96)))
    dev = m.JoltDevice.new()
    dev.inputs.extend(bytes((7 * i + 3) & 0xFF for i in range(40)))
    bus = m.SystemBus(jolt_device=dev, terminal=term)
    bus.disk.init(bytes((i * 13) & 0xFF for i in range(2048)))
    # the UART's interrupts on and routed, so that random stores make
    # and unmake SEIP
    bus.store_phys(m.Plic.BASE + 4 * m.UART_IRQ, 3, 4)
    bus.store_phys(m.Plic.BASE + 0x2080, 1 << m.UART_IRQ, 8)
    bus.store_phys(m.Uart.BASE + 1, 0x3, 1)
    rec = Record()
    for kind, win, off, width, value, ticks in _mmio_script(seed, n_ops):
        if kind == "tick":
            for _ in range(ticks):
                bus.tick()
            rec.append((bus.mip, bus.plic.irq, bus.uart.lsr))
            continue
        a = _window_address(m, bus, win, off)
        if win == "plic" and off % 5 in (0, 3):
            value %= 8          # priorities and threshold that can tie
        if kind == "load":
            rec.call(bus.load_phys, a, width)
        else:
            rec.call(bus.store_phys, a, value, width)
    rec.append(_snapshot(bus))
    rec.append((bus.uart.lsr, bus.plic.irq, bus.disk.used_ring_index))
    return rec


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_bus_accesses_equal_jolt_tpus(seed):
    got, want = _mmio_run(PORT_PKG, seed, 1500), _mmio_run(JAX_PKG, seed,
                                                            1500)
    assert len(got) == len(want)
    faults = sum(1 for r in want if isinstance(r, tuple) and r
                 and r[0] == "RuntimeError")
    assert 0 < faults < len(want) // 2
    assert got == want


def _walk_run(m, mode: str, seed: int, n_ops: int) -> Record:
    """Random page tables (pointers, leaves and superpages with random
    V/R/W/X/A/D bits) and random translated loads, stores and fetches
    under random privilege modes, MPRV and the page cache."""
    rng = np.random.default_rng(seed)
    xlen, pte, levels, idx_bits = (32, 4, 2, 10) if mode == "sv32" \
        else (64, 8, 3, 9)
    bus = m.SystemBus(xlen=xlen)
    tables = [m.DRAM_BASE + 0x10000 + 0x1000 * i for i in range(6)]
    frames = [m.DRAM_BASE + 0x40000 + 0x1000 * i for i in range(8)]
    # the indices the accesses use, per level: every virtual address, and
    # every physical one a superpage makes of it, stays in the first
    # 16 MiB of DRAM, which the DRAM model holds without growing
    top = [0x200 + k for k in range(4)] if mode == "sv32" else [2]
    mid = [] if mode == "sv32" else list(range(8))
    low = [int(x) for x in rng.integers(0, 1 << idx_bits, size=4)]
    hot = [low, mid, top] if mid else [low, top]
    for t in tables:
        for idx in low + mid + top + [int(x) for x in rng.integers(
                0, 1 << idx_bits, size=4)]:
            if rng.random() < 0.4:
                ppn, flags = tables[rng.integers(0, len(tables))] >> 12, 0x1
            else:
                ppn = frames[rng.integers(0, len(frames))] >> 12
                if rng.random() < 0.2:
                    ppn = (ppn >> 10) << 10        # superpage-aligned
                flags = int(rng.integers(0, 256))
            _write_pte(bus, t, idx, ppn, flags, pte)
    for f in frames:
        for k in range(0, 0x1000, 0x100):
            bus.store_phys(f + k, int(rng.integers(0, 1 << 32)), 4)
    bus.update_addressing_mode(mode)
    bus.update_ppn(tables[0] >> 12)
    rec = Record()
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.05:
            bus.update_privilege_mode(int(rng.choice(
                [m.USER, m.SUPERVISOR, m.MACHINE, 2])))
        elif r < 0.08:
            bus.update_mstatus(int(rng.integers(0, 2)) << 17
                               | int(rng.integers(0, 4)) << 9)
        elif r < 0.1:
            bus.enable_page_cache(bool(rng.integers(0, 2)))
        va = int(rng.integers(0, 1 << 12)) & ~7
        for i in range(levels):
            va |= int(rng.choice(hot[i])) << (12 + idx_bits * i)
        if rng.random() < 0.1:
            va = m.DRAM_BASE + int(rng.integers(0, 1 << 16))
        width = int((1, 2, 4, 8)[rng.integers(0, 4)])
        op = rng.integers(0, 3)
        if op == 0:
            rec.call(bus.load, va, width)
        elif op == 1:
            rec.call(bus.store, va, int(rng.integers(0, 1 << 32)), width)
        else:
            rec.call(bus.fetch_word, va)
    rec.append(_snapshot(bus))
    return rec


@pytest.mark.parametrize("mode", ["sv32", "sv39"])
def test_random_page_walks_equal_jolt_tpus(mode):
    got, want = _walk_run(PORT_PKG, mode, 7, 1500), \
        _walk_run(JAX_PKG, mode, 7, 1500)
    kinds = {r[0] for r in want if isinstance(r, tuple) and r
             and isinstance(r[0], str)}
    assert {"ok", "PageFault"} <= kinds
    assert got == want
