// Native RV32IM trace emulator (C ABI, driven from Python via ctypes).
//
// Reference: tracer/src/emulator/cpu.rs (the reference's 4.4k-line Rust
// interpreter) + tracer/src/lib.rs:26-70 (PC-repeat termination heuristic)
// + common/src/rv_trace.rs:637-704 (JoltDevice memory-mapped I/O).
//
// A copy of jolt_tpu's native tracer for the PyTorch port.  Semantics
// mirror tracer/emulator.py exactly (the Python emulator stays as the
// cross-checking oracle: trace_program(native=False)).  Output is columnar:
// one array per trace-row field.
//
// Build: g++ -O3 -shared -fPIC -o libjolt_tracer.so tracer.cpp

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// Opcode codes: must match native/__init__.py OPCODE_CODES.
enum Opc : uint16_t {
  OP_ADD = 1, OP_SUB, OP_XOR, OP_OR, OP_AND, OP_SLL, OP_SRL, OP_SRA,
  OP_SLT, OP_SLTU, OP_ADDI, OP_XORI, OP_ORI, OP_ANDI, OP_SLLI, OP_SRLI,
  OP_SRAI, OP_SLTI, OP_SLTIU, OP_LB, OP_LH, OP_LW, OP_LBU, OP_LHU,
  OP_SB, OP_SH, OP_SW, OP_BEQ, OP_BNE, OP_BLT, OP_BGE, OP_BLTU,
  OP_BGEU, OP_JAL, OP_JALR, OP_LUI, OP_AUIPC, OP_ECALL, OP_EBREAK,
  OP_MUL, OP_MULH, OP_MULHU, OP_MULHSU, OP_MULU, OP_DIV,
  OP_DIVU, OP_REM, OP_REMU, OP_FENCE, OP_UNIMPL,
  OP_VIRTUAL_MOVSIGN, OP_VIRTUAL_MOVE,
};

struct Device {
  const uint8_t* inputs;
  int64_t n_inputs;
  uint64_t input_start, input_end, output_start, panic_addr;
  uint8_t* outputs;      // capacity = max_output_size + 1
  int64_t outputs_cap;
  int64_t outputs_len = 0;
  uint8_t panic = 0;

  bool is_input(uint64_t a) const { return a >= input_start && a < input_end; }
  bool is_output(uint64_t a) const {
    return a >= output_start && a < panic_addr;
  }
  uint8_t load(uint64_t a) const {
    int64_t internal = (int64_t)(a - input_start);
    if (internal < 0 || internal >= n_inputs) return 0;
    return inputs[internal];
  }
  // rv_trace.rs:678-689: store sets the panic bit or grows `outputs`.
  void store(uint64_t a, uint8_t v) {
    if (a == panic_addr) { panic = 1; return; }
    int64_t internal = (int64_t)(a - output_start);
    if (internal < 0 || internal >= outputs_cap) return;  // caller sizes cap
    if (internal + 1 > outputs_len) outputs_len = internal + 1;
    outputs[internal] = v;
  }
};

struct Mem {
  uint8_t* ram;        // flat bytes covering [lo, lo + cap)
  uint64_t lo, cap;
  Device* dev;
  bool oob = false;

  // Mirrors emulator.py load_byte/store_byte: input region reads hit the
  // device; output/panic stores hit the device AND backing RAM.
  uint8_t load_byte(uint64_t a) {
    if (dev->is_input(a)) return dev->load(a);
    uint64_t off = a - lo;
    if (off >= cap) { oob = true; return 0; }
    return ram[off];
  }
  void store_byte(uint64_t a, uint8_t v) {
    if (dev->is_output(a) || a == dev->panic_addr) dev->store(a, v);
    uint64_t off = a - lo;
    if (off >= cap) { oob = true; return; }
    ram[off] = v;
  }
  uint32_t load(uint64_t a, int n) {
    uint32_t v = 0;
    for (int k = 0; k < n; k++) v |= (uint32_t)load_byte(a + k) << (8 * k);
    return v;
  }
  void store(uint64_t a, uint32_t v, int n) {
    for (int k = 0; k < n; k++) store_byte(a + k, (v >> (8 * k)) & 0xFF);
  }
};

inline int32_t s32(uint32_t v) { return (int32_t)v; }

// div.rs:36-58 semantics (via virtual_sequences._signed_divmod): truncated
// division adjusted so sign(rem) == sign(divisor); div-by-zero => q=-1, r=x.
inline void signed_divmod(uint32_t x, uint32_t y, uint32_t* q, uint32_t* r) {
  int64_t xs = s32(x), ys = s32(y);
  if (ys == 0) { *q = 0xFFFFFFFFu; *r = x; return; }
  int64_t qq = xs / ys;            // truncation toward zero (int64: no UB)
  int64_t rr = xs - qq * ys;
  if ((rr < 0 && ys > 0) || (rr > 0 && ys < 0)) { rr += ys; qq -= 1; }
  *q = (uint32_t)qq; *r = (uint32_t)rr;
}

inline void unsigned_divmod(uint32_t x, uint32_t y, uint32_t* q, uint32_t* r) {
  if (y == 0) { *q = 0xFFFFFFFFu; *r = x; return; }
  *q = x / y; *r = x % y;
}

}  // namespace

extern "C" {

// Returns the number of trace rows, or a negative error code:
//   -1: no instruction at PC    -2: unknown opcode
//   -3: memory access out of the modeled range    -4: step limit reached
int64_t jolt_trace(
    // program (n_instr parallel arrays; rd/rs1/rs2 = -1 when absent)
    int64_t n_instr, const uint32_t* p_addr, const uint16_t* p_opc,
    const int16_t* p_rd, const int16_t* p_rs1, const int16_t* p_rs2,
    const uint32_t* p_imm,
    // device / memory layout (rv_trace.rs:706-754)
    const uint8_t* inputs, int64_t n_inputs,
    uint64_t input_start, uint64_t input_end,
    uint64_t output_start, uint64_t panic_addr,
    uint64_t mem_lo, uint64_t mem_cap,
    // limits + outputs (caller allocates max_steps-sized arrays)
    int64_t max_steps,
    uint32_t* out_instr, uint32_t* out_rs1_val, uint32_t* out_rs2_val,
    uint32_t* out_rd_val, uint8_t* out_mem_kind, uint32_t* out_mem_addr,
    uint32_t* out_mem_val,
    uint8_t* outputs_buf, int64_t outputs_cap,
    int64_t* outputs_len, uint8_t* panic_flag) {
  std::unordered_map<uint32_t, int64_t> at;
  at.reserve((size_t)n_instr * 2);
  uint32_t pc = 0xFFFFFFFFu;
  for (int64_t i = 0; i < n_instr; i++) {
    at.emplace(p_addr[i], i);
    if (p_addr[i] < pc) pc = p_addr[i];
  }

  Device dev{inputs, n_inputs, input_start, input_end, output_start,
             panic_addr, outputs_buf, outputs_cap};
  std::vector<uint8_t> ram((size_t)mem_cap, 0);
  Mem mem{ram.data(), mem_lo, mem_cap, &dev};

  uint32_t regs[64] = {0};
  int64_t n = 0;
  int64_t steps;
  for (steps = 0; steps < max_steps; steps++) {
    auto it = at.find(pc);
    if (it == at.end()) return -1;
    int64_t idx = it->second;
    uint16_t op = p_opc[idx];
    int rd = p_rd[idx], rs1 = p_rs1[idx], rs2 = p_rs2[idx];
    uint32_t x1 = rs1 >= 0 ? regs[rs1] : 0;
    uint32_t x2 = rs2 >= 0 ? regs[rs2] : 0;
    int32_t imm = (int32_t)p_imm[idx];
    uint32_t next_pc = pc + 4;
    uint32_t rd_val = 0;
    bool has_rd_val = false;
    uint8_t mem_kind = 0;        // 0 none, 1 read, 2 write
    uint32_t mem_addr = 0, mem_val = 0;

    switch (op) {
      case OP_ADD:  rd_val = x1 + x2; has_rd_val = true; break;
      case OP_ADDI: rd_val = x1 + (uint32_t)imm; has_rd_val = true; break;
      case OP_SUB:  rd_val = x1 - x2; has_rd_val = true; break;
      case OP_XOR:  rd_val = x1 ^ x2; has_rd_val = true; break;
      case OP_XORI: rd_val = x1 ^ (uint32_t)imm; has_rd_val = true; break;
      case OP_OR:   rd_val = x1 | x2; has_rd_val = true; break;
      case OP_ORI:  rd_val = x1 | (uint32_t)imm; has_rd_val = true; break;
      case OP_AND:  rd_val = x1 & x2; has_rd_val = true; break;
      case OP_ANDI: rd_val = x1 & (uint32_t)imm; has_rd_val = true; break;
      case OP_SLL:  rd_val = x1 << (x2 & 31); has_rd_val = true; break;
      case OP_SLLI: rd_val = x1 << ((uint32_t)imm & 31); has_rd_val = true; break;
      case OP_SRL:  rd_val = x1 >> (x2 & 31); has_rd_val = true; break;
      case OP_SRLI: rd_val = x1 >> ((uint32_t)imm & 31); has_rd_val = true; break;
      case OP_SRA:  rd_val = (uint32_t)(s32(x1) >> (x2 & 31));
                    has_rd_val = true; break;
      case OP_SRAI: rd_val = (uint32_t)(s32(x1) >> ((uint32_t)imm & 31));
                    has_rd_val = true; break;
      case OP_SLT:  rd_val = s32(x1) < s32(x2); has_rd_val = true; break;
      case OP_SLTI: rd_val = s32(x1) < imm; has_rd_val = true; break;
      case OP_SLTU: rd_val = x1 < x2; has_rd_val = true; break;
      case OP_SLTIU: rd_val = x1 < (uint32_t)imm; has_rd_val = true; break;
      case OP_LUI:  rd_val = (uint32_t)imm; has_rd_val = true; break;
      case OP_AUIPC: rd_val = pc + (uint32_t)imm; has_rd_val = true; break;
      case OP_JAL:  rd_val = pc + 4; has_rd_val = true;
                    next_pc = pc + (uint32_t)imm; break;
      case OP_JALR: rd_val = pc + 4; has_rd_val = true;
                    next_pc = x1 + (uint32_t)imm; break;
      case OP_BEQ:  if (x1 == x2) next_pc = pc + (uint32_t)imm; break;
      case OP_BNE:  if (x1 != x2) next_pc = pc + (uint32_t)imm; break;
      case OP_BLT:  if (s32(x1) < s32(x2)) next_pc = pc + (uint32_t)imm; break;
      case OP_BGE:  if (s32(x1) >= s32(x2)) next_pc = pc + (uint32_t)imm; break;
      case OP_BLTU: if (x1 < x2) next_pc = pc + (uint32_t)imm; break;
      case OP_BGEU: if (x1 >= x2) next_pc = pc + (uint32_t)imm; break;
      case OP_LB: case OP_LBU: case OP_LH: case OP_LHU: case OP_LW: {
        int nb = (op == OP_LB || op == OP_LBU) ? 1
                 : (op == OP_LH || op == OP_LHU) ? 2 : 4;
        uint32_t a = x1 + (uint32_t)imm;
        uint32_t v = mem.load(a, nb);
        mem_kind = 1; mem_addr = a; mem_val = v;
        if (op == OP_LB) rd_val = (v & 0x80) ? (v | 0xFFFFFF00u) : v;
        else if (op == OP_LH) rd_val = (v & 0x8000) ? (v | 0xFFFF0000u) : v;
        else rd_val = v;
        has_rd_val = true;
        break;
      }
      case OP_SB: case OP_SH: case OP_SW: {
        int nb = op == OP_SB ? 1 : op == OP_SH ? 2 : 4;
        uint32_t a = x1 + (uint32_t)imm;
        uint32_t v = nb == 4 ? x2 : (x2 & ((1u << (8 * nb)) - 1));
        mem.store(a, v, nb);
        mem_kind = 2; mem_addr = a; mem_val = v;
        break;
      }
      case OP_MUL:  rd_val = (uint32_t)((int64_t)s32(x1) * s32(x2));
                    has_rd_val = true; break;
      case OP_MULU: rd_val = (uint32_t)((uint64_t)x1 * x2);
                    has_rd_val = true; break;
      case OP_MULHU: rd_val = (uint32_t)(((uint64_t)x1 * x2) >> 32);
                    has_rd_val = true; break;
      case OP_MULH: rd_val = (uint32_t)(((int64_t)s32(x1) * s32(x2)) >> 32);
                    has_rd_val = true; break;
      case OP_MULHSU: rd_val = (uint32_t)(((int64_t)s32(x1) * (int64_t)x2) >> 32);
                    has_rd_val = true; break;
      case OP_DIV: case OP_REM: {
        uint32_t q, r; signed_divmod(x1, x2, &q, &r);
        rd_val = op == OP_DIV ? q : r; has_rd_val = true; break;
      }
      case OP_DIVU: case OP_REMU: {
        uint32_t q, r; unsigned_divmod(x1, x2, &q, &r);
        rd_val = op == OP_DIVU ? q : r; has_rd_val = true; break;
      }
      case OP_FENCE: case OP_ECALL: case OP_EBREAK: break;
      case OP_VIRTUAL_MOVE: rd_val = x1; has_rd_val = true; break;
      case OP_VIRTUAL_MOVSIGN:
        rd_val = (x1 & 0x80000000u) ? 0xFFFFFFFFu : 0; has_rd_val = true;
        break;
      default: return -2;
    }
    if (mem.oob) return -3;

    if (has_rd_val && rd > 0) regs[rd] = rd_val;

    out_instr[n] = (uint32_t)idx;
    out_rs1_val[n] = x1;
    out_rs2_val[n] = x2;
    out_rd_val[n] = rd >= 0 ? regs[rd] : 0;   // regs[0] stays 0
    out_mem_kind[n] = mem_kind;
    out_mem_addr[n] = mem_addr;
    out_mem_val[n] = mem_val;
    n++;

    if (next_pc == pc) break;                 // lib.rs:48-60 termination
    pc = next_pc;
  }
  if (steps == max_steps) return -4;

  *outputs_len = dev.outputs_len;
  *panic_flag = dev.panic;
  return n;
}

}  // extern "C"
