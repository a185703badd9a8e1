"""The port's guests, tracers, ELF files, Keccak and SDK against jolt_tpu's.

- each guest of vm/guests.py (collatz, sha3-chain with both pads,
  alloc_sum, multi_function, stdlib) is jolt_tpu's program instruction for
  instruction;
- the port's native tracer (native/tracer.cpp) and its Python emulator
  give the same trace, step for step, as jolt_tpu's trace_program, and the
  guest's output equals its host oracle (hashlib for sha3-chain);
- `trace_analyze`'s histogram is jolt_tpu's;
- the native keccak256 equals keccak256_py and the frozen transcript
  vectors (fixtures/transcript_vectors.json);
- `write_elf` writes jolt_tpu's bytes, and `decode_elf`, given bytes or a
  path, decodes what jolt_tpu's does;
- the SDK refuses an ELF file with a memory image, and a failed native
  build raises instead of running the Python versions;
- `slow`: the SDK proves stdlib(13) with the mock PCS on the CPU with
  jolt_tpu's transcript.

Every comparison is exact.
"""
import dataclasses
import enum
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from jolt_tpu.tracer import elf as jelf
from jolt_tpu.tracer import elf_write as jelf_write
from jolt_tpu.utils.keccak import keccak256 as j_keccak256
from jolt_tpu.vm import analyze as janalyze
from jolt_tpu.vm import guests as jguests
from jolt_tpu.vm import host as jhost
from jolt_tpu.vm.rv32i_vm import rv32i_vm as j_rv32i_vm
from jolt_tpu_torch import native, sdk
from jolt_tpu_torch.curve.bn254 import G1Affine
from jolt_tpu_torch.field.host import FElt
from jolt_tpu_torch.field.spec import fr_spec
from jolt_tpu_torch.tracer import elf, elf_write
from jolt_tpu_torch.transcript import Transcript
from jolt_tpu_torch.utils import keccak
from jolt_tpu_torch.vm import guests
from jolt_tpu_torch.vm.analyze import trace_analyze
from jolt_tpu_torch.vm.host import trace_program
from jolt_tpu_torch.vm.rv32i_vm import rv32i_vm

ROOT = Path(__file__).resolve().parents[1]
INPUT = b"\x05" * 32

# name -> (port program, jolt_tpu program, inputs, expected output)
GUESTS = {
    "collatz": (lambda: guests.collatz_program(27),
                lambda: jguests.collatz_program(27), b"",
                guests.collatz_expected(27).to_bytes(4, "little")),
    "alloc_sum": (lambda: guests.alloc_sum_program(100),
                  lambda: jguests.alloc_sum_program(100), b"",
                  guests.alloc_sum_expected(100).to_bytes(4, "little")),
    "multi_function": (lambda: guests.multi_function_program(100),
                       lambda: jguests.multi_function_program(100), b"",
                       guests.multi_function_expected(100)
                       .to_bytes(4, "little")),
    "stdlib": (lambda: guests.stdlib_program(13),
               lambda: jguests.stdlib_program(13), b"",
               guests.stdlib_expected(13)),
    "sha3_chain": (lambda: guests.sha3_chain_program(1),
                   lambda: jguests.sha3_chain_program(1), INPUT,
                   hashlib.sha3_256(INPUT).digest()),
}


def _plain(x):
    """Dataclasses as dicts and enums as their names, for comparing the
    two packages' host objects."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.name
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.fixture(scope="module")
def vms():
    return rv32i_vm(), j_rv32i_vm()


# ---------------------------------------------------------------------------
# guests and tracers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pad", [0x06, 0x01])
def test_sha3_chain_program_and_oracle_match_jolt_tpu(pad):
    prog = guests.sha3_chain_program(2, pad_byte=pad)
    assert _plain(prog) == _plain(jguests.sha3_chain_program(2, pad_byte=pad))
    assert len(prog) == 1199
    want = guests.sha3_chain_expected(INPUT, 2, pad)
    assert want == jguests.sha3_chain_expected(INPUT, 2, pad)
    h = INPUT
    for _ in range(2):
        h = hashlib.sha3_256(h).digest() if pad == 0x06 else j_keccak256(h)
    assert want == h


@pytest.mark.parametrize("guest", GUESTS)
def test_guest_traces_match_jolt_tpu(guest, vms):
    """Native trace == Python emulator == jolt_tpu's trace, step for step,
    and the output is the oracle's."""
    build, jbuild, inputs, want = GUESTS[guest]
    prog = build()
    assert _plain(prog) == _plain(jbuild())
    vm, jvm = vms
    steps, io, rows = trace_program(prog, vm, inputs=inputs)
    psteps, pio, prows = trace_program(prog, vm, inputs=inputs, native=False)
    jsteps, jio, jrows = jhost.trace_program(jbuild(), jvm, inputs=inputs,
                                             native=False)
    assert len(steps) == len(psteps) == len(jsteps) > 0
    assert _plain(steps) == _plain(psteps) == _plain(jsteps)
    assert _plain(rows) == _plain(prows) == _plain(jrows)
    assert bytes(io.outputs) == bytes(pio.outputs) == bytes(jio.outputs)
    assert io.panic == pio.panic == jio.panic is False
    assert bytes(io.outputs)[:len(want)] == want


def test_trace_analyze_matches_jolt_tpu(vms):
    vm, jvm = vms
    s = trace_analyze(guests.collatz_program(27), vm)
    js = janalyze.trace_analyze(jguests.collatz_program(27), jvm)
    assert s.trace_len() == js.trace_len() == 826
    assert [(op.name, k) for op, k in s.analyze()] == \
        [(op.name, k) for op, k in js.analyze()]
    assert _plain(s.processed_trace) == _plain(js.processed_trace)
    assert bytes(s.io_device.outputs) == bytes(js.io_device.outputs)


def test_cli_analyze_prints_jolt_tpus_histogram(vms, capsys):
    from jolt_tpu_torch import cli
    cli.main(["analyze", "--guest", "sha3-chain", "--n", "1"])
    got = json.loads(capsys.readouterr().out)
    js = janalyze.trace_analyze(jguests.sha3_chain_program(1), vms[1],
                                inputs=INPUT)
    assert got["trace_length"] == js.trace_len() == 22336
    assert got["opcodes"] == {op.name: k for op, k in js.analyze()}
    assert "JALR" in got["opcodes"]


# ---------------------------------------------------------------------------
# Keccak
# ---------------------------------------------------------------------------

def test_native_keccak_matches_python_keccak():
    rng = np.random.default_rng(5)
    for n in (0, 1, 31, 32, 64, 135, 136, 137, 271, 272, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert keccak.keccak256(data) == keccak.keccak256_py(data) == \
            j_keccak256(data), n
    assert keccak.keccak256(b"").hex() == \
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"


@pytest.mark.parametrize("hasher", ["native", "python"])
def test_transcript_replays_the_frozen_vectors(hasher, monkeypatch):
    """fixtures/transcript_vectors.json (every append and challenge kind)
    with the native Keccak and with keccak256_py."""
    from jolt_tpu_torch import transcript as tmod
    if hasher == "python":
        monkeypatch.setattr(tmod, "keccak256", keccak.keccak256_py)
    fix = json.loads((ROOT / "fixtures" / "transcript_vectors.json")
                     .read_text())
    fr = fr_spec()
    t = Transcript(fix["label"].encode())
    g = G1Affine.generator()
    g2 = g.to_jacobian().double().to_affine()
    for e in fix["events"]:
        k = e["kind"]
        if k == "message":
            t.append_message(e["msg"].encode())
        elif k == "u64":
            t.append_u64(e["value"])
        elif k == "bytes":
            t.append_bytes(bytes.fromhex(e["data"]))
        elif k == "scalar":
            t.append_scalar(FElt(int(e["value"]), fr))
        elif k == "point":
            t.append_point(g)
        elif k == "point_infinity":
            t.append_point(None)
        elif k == "scalars":
            t.append_scalars([FElt(int(v), fr) for v in e["values"]])
        elif k == "points":
            t.append_points([g, g2])
        elif k == "challenge_scalar":
            assert str(t.challenge_scalar().v) == e["value"]
        elif k == "challenge_vector":
            got = t.challenge_vector(len(e["values"]))
            assert [str(c.v) for c in got] == e["values"]
        elif k == "challenge_powers":
            got = t.challenge_scalar_powers(len(e["values"]))
            assert [str(c.v) for c in got] == e["values"]
        else:
            assert k == "init", k
        assert t.state.hex() == e["state"], k


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------

@pytest.fixture
def broken_compiler(monkeypatch, tmp_path):
    """The port's native build pointed at a compiler that does not exist,
    with an empty build directory and no library loaded."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    native.tracer_library.cache_clear()
    native.keccak_library.cache_clear()
    yield
    native.tracer_library.cache_clear()
    native.keccak_library.cache_clear()


def test_a_failed_native_build_raises(broken_compiler, vms):
    with pytest.raises(RuntimeError, match="no-such-g"):
        trace_program(guests.collatz_program(27), vms[0])
    with pytest.raises(RuntimeError, match="no-such-g"):
        keccak.keccak256(b"abc")
    with pytest.raises(RuntimeError, match="no-such-g"):
        Transcript(b"Jolt transcript")
    assert not list(native.BUILD_DIR.glob("*.so"))


def test_a_failed_native_trace_raises(vms):
    """A program that runs off its end: the native tracer's error reaches
    the caller (jolt_tpu's trace_program catches it and reruns the Python
    emulator)."""
    prog = guests.collatz_program(27)[:-1]          # no halting self-loop
    with pytest.raises(RuntimeError, match="native tracer failed"):
        trace_program(prog, vms[0])


# ---------------------------------------------------------------------------
# ELF
# ---------------------------------------------------------------------------

ELF_CASES = {**{g: (v[0], v[1], b"") for g, v in GUESTS.items()},
             "sha2_chain_data": (lambda: guests.sha2_chain_program(1),
                                 lambda: jguests.sha2_chain_program(1),
                                 bytes(range(37)))}


def _same_decoding(got, want):
    (ins, mem, entry), (jins, jmem, jentry) = got, want
    assert _plain(ins) == _plain(jins)
    assert mem == jmem
    assert entry == jentry


@pytest.mark.parametrize("case", ELF_CASES)
def test_elf_files_match_jolt_tpu(case, tmp_path):
    build, jbuild, data = ELF_CASES[case]
    path, jpath = tmp_path / "port.elf", tmp_path / "jolt_tpu.elf"
    elf_write.write_elf(str(path), build(), data=data)
    jelf_write.write_elf(str(jpath), jbuild(), data=data)
    image = path.read_bytes()
    assert image == jpath.read_bytes()
    assert image == elf_write.elf_image(build(), data=data)
    want = jelf.decode_elf(str(jpath))
    _same_decoding(elf.decode_elf(image), want)
    _same_decoding(elf.decode_elf(str(path)), want)
    _same_decoding(elf.decode_elf(path), want)
    assert bool(want[1]) == bool(data)


def test_decode_elf_matches_jolt_tpu_on_the_guest_fixture():
    path = ROOT / "fixtures" / "guests" / "sha2_chain_1.elf"
    want = jelf.decode_elf(str(path))
    _same_decoding(elf.decode_elf(path.read_bytes()), want)
    _same_decoding(elf.decode_elf(str(path)), want)
    assert _plain(want[0]) == _plain(jguests.sha2_chain_program(1))


def test_decode_word_matches_jolt_tpu_on_random_words():
    rng = np.random.default_rng(11)
    for w in rng.integers(0, 1 << 32, 4000, dtype=np.uint64).tolist():
        assert _plain(elf.decode_word(w, 0x80000000)) == \
            _plain(jelf.decode_word(w, 0x80000000)), hex(w)


def test_decode_elf_refuses_what_is_not_an_elf32_le_file():
    image = elf_write.elf_image(guests.collatz_program(27))
    for bad in (b"", b"\x7fELX" + image[4:], image[:4] + b"\x02" + image[5:],
                image[:-8]):
        with pytest.raises(ValueError):
            elf.decode_elf(bad)


def test_sdk_refuses_an_elf_file_with_a_memory_image():
    image = elf_write.elf_image(guests.collatz_program(27), data=b"\x01\x02")
    prove, verify = sdk.build_provable(image, pcs="mock", device="cpu")
    with pytest.raises(ValueError, match="memory"):
        prove()
    with pytest.raises(RuntimeError, match="prove"):
        verify(None)


def test_sdk_refuses_an_entry_the_tracer_does_not_start_at():
    image = elf_write.elf_image(guests.collatz_program(27),
                                entry=0x80000004)
    with pytest.raises(ValueError, match="entry"):
        sdk.build_provable(image, pcs="mock", device="cpu")


# ---------------------------------------------------------------------------
# slow: the SDK end to end on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_sdk_proves_stdlib_with_jolt_tpus_transcript(monkeypatch):
    """build_provable(stdlib_program(13)) with the mock PCS on the CPU (the
    full VM at M = 2^16: minutes), from the ELF bytes, against jolt_tpu's
    build_provable on the instruction list; the transcripts are captured
    from each package's JoltVM.prove."""
    from jolt_tpu import sdk as jsdk
    from jolt_tpu.vm.jolt import JoltVM as JJoltVM
    from jolt_tpu_torch.vm.jolt import JoltVM

    seen = {}

    def capture(cls, key):
        orig = cls.prove

        def prove(self, *args):
            out = orig(self, *args)
            seen[key] = out[2].state_history
            return out
        monkeypatch.setattr(cls, "prove", prove)

    capture(JoltVM, "port")
    capture(JJoltVM, "jolt_tpu")
    image = elf_write.elf_image(guests.stdlib_program(13))
    prove, verify = sdk.build_provable(image, pcs="mock", device="cpu")
    outputs, art = prove()
    assert outputs[:16] == guests.stdlib_expected(13)
    assert verify(art)
    jprove, jverify = jsdk.build_provable(jguests.stdlib_program(13),
                                          pcs="mock")
    joutputs, jart = jprove()
    assert joutputs == outputs and jart.trace_length == art.trace_length
    assert seen["port"] == seen["jolt_tpu"]
