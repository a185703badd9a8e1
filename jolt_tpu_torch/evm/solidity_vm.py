"""A Solidity-subset interpreter that EXECUTES evm_verifier/src/*.sol
(jolt_tpu/evm/solidity_vm.py, carried over).

The reference repo compiles its Solidity verifier with forge and runs it
in CI against Rust-generated fixtures (.github/workflows/rust.yml:60-84).
Without solc or forge, this module parses the exact dialect the verifier
libraries use (value types and global operator binding, libraries with
`using ... for`, memory structs and arrays, BN254 precompiles via
`address(0x05..0x08).staticcall`, keccak256 and abi.encode[Packed]/decode)
and evaluates it directly, so tests drive the REAL .sol sources against
the fixtures the port generates (evm/fixtures.py).

Not supported (not used by the verifier sources): storage, mappings,
inheritance, modifiers, events, assembly, try/catch, contracts (only
libraries, free functions and one user value type).

The precompiles run on the port's host BN254 arithmetic
(curve/bn254.py, curve/pairing.py), pure Python.  `load_vm` reads
evm_verifier/src/subprotocols/ and writes nothing anywhere.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<hex>0x[0-9a-fA-F]+)
  | (?P<num>\d+)
  | (?P<str>"(?:[^"\\]|\\.)*")
  | (?P<ident>[A-Za-z_$][A-Za-z0-9_$]*)
  | (?P<punct><<=|>>=|\+\+|--|\*\*|<<|>>|<=|>=|==|!=|&&|\|\||\+=|-=|\*=|/=|%=|\|=|&=|\^=|=>|[-+*/%<>=!&|^~?:;,.(){}\[\]])
""", re.VERBOSE | re.DOTALL)

KEYWORDS = {
    "pragma", "import", "library", "struct", "function", "returns", "return",
    "if", "else", "for", "while", "require", "revert", "using", "type",
    "is", "global", "constant", "memory", "calldata", "storage", "new",
    "internal", "external", "public", "private", "pure", "view", "true",
    "false",
}


@dataclass
class Tok:
    kind: str       # num, hex, str, ident, punct
    text: str
    pos: int


def tokenize(src: str) -> list[Tok]:
    out, i = [], 0
    while i < len(src):
        m = _TOKEN_RE.match(src, i)
        if not m:
            raise SyntaxError(f"lex error at {src[i:i+40]!r}")
        i = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        out.append(Tok(kind, m.group(), m.start()))
    out.append(Tok("eof", "", len(src)))
    return out


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclass
class TypeName:
    base: str                      # "uint256", "Fr", "SumcheckVerifier.SumcheckProof"
    dims: tuple = ()               # () scalar; entries: None (dyn) or int (fixed)


@dataclass
class Param:
    type: TypeName
    name: str | None


@dataclass
class FuncDecl:
    name: str
    params: list[Param]
    rets: list[Param]
    body: list
    lib: str | None = None


@dataclass
class StructDecl:
    name: str
    fields: list[Param]


@dataclass
class LibraryDecl:
    name: str
    funcs: dict = field(default_factory=dict)
    structs: dict = field(default_factory=dict)
    consts: dict = field(default_factory=dict)     # name -> (TypeName, expr)
    usings: list = field(default_factory=list)     # (libname, typename)


# Expressions are tuples: ("num", v), ("str", s), ("bool", b),
# ("ident", name), ("member", obj, name), ("index", obj, idx),
# ("call", callee, [args]), ("bin", op, l, r), ("un", op, e),
# ("ternary", c, a, b), ("new_arr", TypeName, size_expr), ("tuple", [elts])
# Statements: ("expr", e), ("decl", [(TypeName|None, name|lvalue)], rhs|None),
# ("assign", op, lvalue, rhs), ("if", c, then, els), ("for", init, cond,
# post, body), ("return", expr|None), ("require", cond, msg),
# ("revert", msg), ("block", stmts), ("postfix", op, lvalue)


class Parser:
    def __init__(self, toks: list[Tok]):
        self.toks = toks
        self.i = 0

    # -- token helpers --
    def peek(self, k=0) -> Tok:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, text: str) -> bool:
        if self.peek().text == text:
            self.i += 1
            return True
        return False

    def expect(self, text: str) -> Tok:
        t = self.next()
        if t.text != text:
            raise SyntaxError(f"expected {text!r}, got {t.text!r} @{t.pos}")
        return t

    def ident(self) -> str:
        t = self.next()
        if t.kind != "ident":
            raise SyntaxError(f"expected identifier, got {t.text!r} @{t.pos}")
        return t.text

    # -- file level --
    def parse_file(self):
        decls = []
        while self.peek().kind != "eof":
            t = self.peek().text
            if t == "pragma":
                while self.next().text != ";":
                    pass
            elif t == "import":
                while self.next().text != ";":
                    pass
            elif t == "type":                 # type Fr is uint256;
                self.next()
                name = self.ident()
                self.expect("is")
                base = self.ident()
                self.expect(";")
                decls.append(("valuetype", name, base))
            elif t == "using":
                decls.append(self.parse_using())
            elif t == "struct":
                decls.append(("struct", self.parse_struct()))
            elif t == "library":
                decls.append(("library", self.parse_library()))
            elif t == "function":
                decls.append(("func", self.parse_function()))
            elif self.peek().kind == "ident":
                # top-level constant: uint256 constant NAME = expr;
                decls.append(("const", self.parse_constant()))
            else:
                raise SyntaxError(f"unexpected {t!r} at file level")
        return decls

    def parse_using(self):
        self.expect("using")
        if self.accept("{"):
            ops = []
            while True:
                fn = self.ident()
                op = None
                if self.accept("as"):
                    op = self.next().text
                ops.append((fn, op))
                if not self.accept(","):
                    break
            self.expect("}")
            self.expect("for")
            tname = self.parse_typename().base
            self.accept("global")
            self.expect(";")
            return ("using_ops", ops, tname)
        lib = self.ident()
        self.expect("for")
        tname = self.parse_typename().base
        self.accept("global")
        self.expect(";")
        return ("using_for", lib, tname)

    def parse_struct(self) -> StructDecl:
        self.expect("struct")
        name = self.ident()
        self.expect("{")
        fields = []
        while not self.accept("}"):
            ty = self.parse_typename()
            fname = self.ident()
            self.expect(";")
            fields.append(Param(ty, fname))
        return StructDecl(name, fields)

    def parse_constant(self):
        ty = self.parse_typename()
        self.expect("constant")
        name = self.ident()
        self.expect("=")
        expr = self.parse_expr()
        self.expect(";")
        return (name, ty, expr)

    def parse_library(self) -> LibraryDecl:
        self.expect("library")
        lib = LibraryDecl(self.ident())
        self.expect("{")
        while not self.accept("}"):
            t = self.peek().text
            if t == "using":
                u = self.parse_using()
                if u[0] == "using_for":
                    lib.usings.append((u[1], u[2]))
            elif t == "struct":
                s = self.parse_struct()
                lib.structs[s.name] = s
            elif t == "function":
                f = self.parse_function()
                f.lib = lib.name
                lib.funcs[f.name] = f
            else:
                name, ty, expr = self.parse_constant()
                lib.consts[name] = (ty, expr)
        return lib

    def parse_typename(self) -> TypeName:
        base = self.ident()
        while self.accept("."):
            base += "." + self.ident()
        dims = []
        while self.peek().text == "[":
            self.next()
            if self.accept("]"):
                dims.append(None)
            else:
                sz = self.parse_expr()
                self.expect("]")
                dims.append(sz)
        return TypeName(base, tuple(dims))

    def parse_function(self) -> FuncDecl:
        self.expect("function")
        name = self.ident()
        self.expect("(")
        params = []
        while not self.accept(")"):
            ty = self.parse_typename()
            while self.peek().text in ("memory", "calldata"):
                self.next()
            pname = None
            if self.peek().kind == "ident" and self.peek().text not in (
                    ",", ")"):
                pname = self.ident()
            params.append(Param(ty, pname))
            self.accept(",")
        while self.peek().text in ("internal", "external", "public",
                                   "private", "pure", "view"):
            self.next()
        rets = []
        if self.accept("returns"):
            self.expect("(")
            while not self.accept(")"):
                ty = self.parse_typename()
                while self.peek().text in ("memory", "calldata"):
                    self.next()
                rname = None
                if self.peek().kind == "ident" and self.peek().text not in (
                        ",", ")"):
                    rname = self.ident()
                rets.append(Param(ty, rname))
                self.accept(",")
        body = self.parse_block()
        return FuncDecl(name, params, rets, body)

    # -- statements --
    def parse_block(self) -> list:
        self.expect("{")
        stmts = []
        while not self.accept("}"):
            stmts.append(self.parse_stmt())
        return stmts

    def parse_stmt(self):
        t = self.peek().text
        if t == "{":
            return ("block", self.parse_block())
        if t == "if":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            then = self.parse_stmt()
            els = None
            if self.accept("else"):
                els = self.parse_stmt()
            return ("if", cond, then, els)
        if t == "for":
            self.next()
            self.expect("(")
            init = None if self.peek().text == ";" else self.parse_simple()
            self.expect(";")
            cond = None if self.peek().text == ";" else self.parse_expr()
            self.expect(";")
            post = None if self.peek().text == ")" else self.parse_simple()
            self.expect(")")
            body = self.parse_stmt()
            return ("for", init, cond, post, body)
        if t == "return":
            self.next()
            if self.accept(";"):
                return ("return", None)
            e = self.parse_expr_or_tuple()
            self.expect(";")
            return ("return", e)
        if t == "require":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            msg = None
            if self.accept(","):
                msg = self.parse_expr()
            self.expect(")")
            self.expect(";")
            return ("require", cond, msg)
        if t == "revert":
            self.next()
            self.expect("(")
            msg = None if self.peek().text == ")" else self.parse_expr()
            self.expect(")")
            self.expect(";")
            return ("revert", msg)
        s = self.parse_simple()
        self.expect(";")
        return s

    def parse_simple(self):
        """Declaration / assignment / expression (no trailing ;)."""
        save = self.i
        # tuple decl/assign:  (T a, bytes memory b) = rhs   /  (a, b) = (b, a)
        if self.peek().text == "(" and self._looks_like_tuple_lhs():
            self.next()
            targets = []
            while not self.accept(")"):
                targets.append(self._parse_decl_or_lvalue())
                self.accept(",")
            self.expect("=")
            rhs = self.parse_expr_or_tuple()
            return ("decl", targets, rhs)
        # plain decl: TypeName [memory] name [= expr]
        if self.peek().kind == "ident" and self.peek().text not in KEYWORDS:
            try:
                ty = self.parse_typename()
                while self.peek().text in ("memory", "calldata"):
                    self.next()
                if self.peek().kind == "ident" and \
                        self.peek(1).text in ("=", ";", ","):
                    name = self.ident()
                    rhs = None
                    if self.accept("="):
                        rhs = self.parse_expr_or_tuple()
                    return ("decl", [(ty, name)], rhs)
            except SyntaxError:
                pass
            self.i = save
        # assignment or expression
        e = self.parse_expr()
        t = self.peek().text
        if t in ("=", "+=", "-=", "*=", "/=", "%=", "|=", "&=", "^=",
                 "<<=", ">>="):
            self.next()
            rhs = self.parse_expr_or_tuple()
            return ("assign", t, e, rhs)
        if t in ("++", "--"):
            self.next()
            return ("postfix", t, e)
        return ("expr", e)

    def _looks_like_tuple_lhs(self) -> bool:
        """Lookahead: '(' ... ')' '=' at the same depth."""
        depth, j = 0, self.i
        while j < len(self.toks):
            txt = self.toks[j].text
            if txt == "(":
                depth += 1
            elif txt == ")":
                depth -= 1
                if depth == 0:
                    return self.toks[j + 1].text == "="
            elif txt == ";":
                return False
            j += 1
        return False

    def _parse_decl_or_lvalue(self):
        save = self.i
        if self.peek().kind == "ident" and self.peek().text not in KEYWORDS:
            try:
                ty = self.parse_typename()
                while self.peek().text in ("memory", "calldata"):
                    self.next()
                if self.peek().kind == "ident" and \
                        self.peek(1).text in (",", ")"):
                    return (ty, self.ident())
            except SyntaxError:
                pass
            self.i = save
        return (None, self.parse_expr())

    # -- expressions (precedence climbing) --
    _BINOPS = [  # lowest to highest
        ("||",), ("&&",), ("==", "!="), ("<", ">", "<=", ">="),
        ("|",), ("^",), ("&",), ("<<", ">>"), ("+", "-"),
        ("*", "/", "%"), ("**",),
    ]

    def parse_expr_or_tuple(self):
        if self.peek().text == "(" and self._tuple_rhs():
            self.next()
            elts = []
            while not self.accept(")"):
                elts.append(self.parse_expr())
                self.accept(",")
            return ("tuple", elts)
        return self.parse_expr()

    def _tuple_rhs(self) -> bool:
        """'(' a ',' ... ')' not followed by an operator → tuple literal."""
        depth, j, has_comma = 0, self.i, False
        while j < len(self.toks):
            txt = self.toks[j].text
            if txt == "(":
                depth += 1
            elif txt == ")":
                depth -= 1
                if depth == 0:
                    nxt = self.toks[j + 1].text
                    return has_comma and nxt in (";", ")", ",")
            elif txt == "," and depth == 1:
                has_comma = True
            elif txt == ";":
                return False
            j += 1
        return False

    def parse_expr(self, level: int = 0):
        if level == 0:
            cond = self.parse_expr(1)
            if self.accept("?"):
                a = self.parse_expr()
                self.expect(":")
                b = self.parse_expr()
                return ("ternary", cond, a, b)
            return cond
        if level > len(self._BINOPS):
            return self.parse_unary()
        ops = self._BINOPS[level - 1]
        left = self.parse_expr(level + 1)
        while self.peek().text in ops:
            op = self.next().text
            right = self.parse_expr(level + 1)
            left = ("bin", op, left, right)
        return left

    def parse_unary(self):
        t = self.peek().text
        if t in ("!", "-", "~"):
            self.next()
            return ("un", t, self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_primary()
        while True:
            if self.accept("."):
                name = self.ident()
                e = ("member", e, name)
            elif self.accept("["):
                idx = self.parse_expr()
                self.expect("]")
                e = ("index", e, idx)
            elif self.peek().text == "(":
                self.next()
                args = []
                while not self.accept(")"):
                    args.append(self.parse_expr())
                    self.accept(",")
                e = ("call", e, args)
            else:
                return e

    def parse_primary(self):
        t = self.next()
        if t.kind == "num":
            return ("num", int(t.text))
        if t.kind == "hex":
            return ("num", int(t.text, 16))
        if t.kind == "str":
            body = t.text[1:-1]
            return ("str", body.encode().decode("unicode_escape"))
        if t.text == "true":
            return ("bool", True)
        if t.text == "false":
            return ("bool", False)
        if t.text == "[":
            elts = []
            while not self.accept("]"):
                elts.append(self.parse_expr())
                self.accept(",")
            return ("arrlit", elts)
        if t.text == "new":
            ty = self.parse_typename()
            self.expect("(")
            size = self.parse_expr()
            self.expect(")")
            return ("new_arr", ty, size)
        if t.text == "(":
            elts = [self.parse_expr()]
            while self.accept(","):
                elts.append(self.parse_expr())
            self.expect(")")
            return elts[0] if len(elts) == 1 else ("tuple", elts)
        if t.kind == "ident":
            return ("ident", t.text)
        raise SyntaxError(f"unexpected token {t.text!r} @{t.pos}")


# ---------------------------------------------------------------------------
# Runtime values
# ---------------------------------------------------------------------------

class SolidityRevert(Exception):
    pass


@dataclass
class Wrapped:
    """User-defined value type instance (e.g. Fr)."""
    type: str
    val: int

    def __eq__(self, other):
        return isinstance(other, Wrapped) and self.type == other.type \
            and self.val == other.val

    def __hash__(self):
        return hash((self.type, self.val))


class StructVal(dict):
    """Memory struct — dict with a type tag; reference semantics."""
    def __init__(self, typename: str, fields: dict):
        super().__init__(fields)
        self.typename = typename


class _Return(Exception):
    def __init__(self, value):
        self.value = value


_UINT_RE = re.compile(r"^uint(\d*)$")
_BYTES_RE = re.compile(r"^bytes(\d+)$")


# ---------------------------------------------------------------------------
# Precompiles (delegate to the framework's host BN254 arithmetic)
# ---------------------------------------------------------------------------

def _words(data: bytes):
    return [int.from_bytes(data[i:i + 32], "big")
            for i in range(0, len(data), 32)]


def _precompile_modexp(data: bytes) -> bytes:
    bl = int.from_bytes(data[0:32], "big")
    el = int.from_bytes(data[32:64], "big")
    ml = int.from_bytes(data[64:96], "big")
    o = 96
    b = int.from_bytes(data[o:o + bl], "big"); o += bl
    e = int.from_bytes(data[o:o + el], "big"); o += el
    m = int.from_bytes(data[o:o + ml], "big")
    return pow(b, e, m).to_bytes(ml, "big") if m else b"\x00" * ml


def _g1(x: int, y: int):
    from ..curve.bn254 import G1Affine
    if x == 0 and y == 0:
        return G1Affine.identity()
    return G1Affine(x, y)


def _g1_out(p) -> bytes:
    if p.is_infinity:
        return b"\x00" * 64
    return p.x.to_bytes(32, "big") + p.y.to_bytes(32, "big")


def _precompile_ecadd(data: bytes) -> bytes:
    x1, y1, x2, y2 = _words(data.ljust(128, b"\x00"))[:4]
    a = _g1(x1, y1).to_jacobian()
    b = _g1(x2, y2).to_jacobian()
    return _g1_out(a.add(b).to_affine())


def _precompile_ecmul(data: bytes) -> bytes:
    x, y, s = _words(data.ljust(96, b"\x00"))[:3]
    return _g1_out(_g1(x, y).to_jacobian().mul(s).to_affine())


def _precompile_pairing(data: bytes) -> bytes:
    from ..curve.bn254 import G2Affine
    from ..curve.pairing import pairing_product_is_one
    pairs = []
    for o in range(0, len(data), 192):
        # G2 coords arrive imaginary-first per the precompile convention
        x, y, xi, xr, yi, yr = _words(data[o:o + 192])
        g2 = G2Affine.identity() if (xi | xr | yi | yr) == 0 \
            else G2Affine((xr, xi), (yr, yi))
        pairs.append((_g1(x, y), g2))
    ok = pairing_product_is_one(pairs)
    return (1 if ok else 0).to_bytes(32, "big")


PRECOMPILES = {
    0x05: _precompile_modexp,
    0x06: _precompile_ecadd,
    0x07: _precompile_ecmul,
    0x08: _precompile_pairing,
}


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------

class SolidityVM:
    """Loads every .sol file in a directory into one global scope
    (mirroring solc's import flattening for these libraries) and exposes
    `call("Library.function", args...)`."""

    def __init__(self, src_dir: str):
        self.value_types: dict[str, str] = {}        # Fr -> uint256
        self.op_bindings: dict[str, dict] = {}       # Fr -> {"+": FuncDecl}
        self.structs: dict[str, StructDecl] = {}     # qualified + bare names
        self.libraries: dict[str, LibraryDecl] = {}
        self.free_funcs: dict[str, FuncDecl] = {}
        self.consts: dict[str, object] = {}
        self.using_for: dict[str, list[str]] = {}    # typename -> [libs]
        self._pending_ops = []
        self._pending_consts = []
        for fn in sorted(os.listdir(src_dir)):
            if fn.endswith(".sol"):
                with open(os.path.join(src_dir, fn)) as f:
                    self._load(f.read())
        # resolve operator bindings + constants after all decls are in
        for ops, tname in self._pending_ops:
            b = self.op_bindings.setdefault(tname, {})
            for fn_name, op in ops:
                if op:
                    b[op] = self.free_funcs[fn_name]
        for name, _ty, expr in self._pending_consts:
            self.consts[name] = self._eval(expr, {"__lib": None})
        for lib in self.libraries.values():
            for cname, (cty, cexpr) in lib.consts.items():
                lib.consts[cname] = (
                    cty, self._eval(cexpr, {"__lib": lib.name}))

    def _load(self, src: str):
        for d in Parser(tokenize(src)).parse_file():
            kind = d[0]
            if kind == "valuetype":
                self.value_types[d[1]] = d[2]
            elif kind == "using_ops":
                self._pending_ops.append((d[1], d[2]))
            elif kind == "using_for":
                self.using_for.setdefault(d[2], []).append(d[1])
            elif kind == "struct":
                self.structs[d[1].name] = d[1]
            elif kind == "library":
                lib = d[1]
                self.libraries[lib.name] = lib
                for sname, s in lib.structs.items():
                    self.structs[f"{lib.name}.{sname}"] = s
                    self.structs.setdefault(sname, s)
                for l_, t_ in lib.usings:
                    self.using_for.setdefault(t_, []).append(l_)
            elif kind == "func":
                self.free_funcs[d[1].name] = d[1]
            elif kind == "const":
                self._pending_consts.append(d[1])

    # -- public API --
    def call(self, qualname: str, *args):
        """Call Library.function (or a free function) with Python values."""
        if "." in qualname:
            libname, fname = qualname.split(".", 1)
            fn = self.libraries[libname].funcs[fname]
        else:
            fn = self.free_funcs[qualname]
        return self._call_fn(fn, list(args))

    def make_struct(self, typename: str, **fields) -> StructVal:
        sd = self.structs[typename]
        inst = self.zero_struct(typename)
        for k, v in fields.items():
            assert k in (f.name for f in sd.fields), \
                f"{typename} has no field {k}"
            inst[k] = v
        return inst

    def zero_struct(self, typename: str) -> StructVal:
        sd = self.structs[typename]
        return StructVal(
            typename,
            {f.name: self._zero(f.type) for f in sd.fields})

    def fr(self, v: int) -> Wrapped:
        return Wrapped("Fr", v)

    # -- value helpers --
    def _zero(self, ty: TypeName):
        if ty.dims:
            inner = TypeName(ty.base, ty.dims[1:])
            d = ty.dims[0]
            if d is None:
                return []
            n = d if isinstance(d, int) else self._eval(d, {"__lib": None})
            return [self._zero(inner) for _ in range(n)]
        b = ty.base
        if b in self.value_types:
            return Wrapped(b, 0)
        if _UINT_RE.match(b) or b == "bool":
            return 0 if b != "bool" else False
        if _BYTES_RE.match(b):
            return b"\x00" * int(_BYTES_RE.match(b).group(1))
        if b == "bytes":
            return b""
        if b in self.structs:
            sd = self.structs[b]
            return StructVal(b, {f.name: self._zero(f.type)
                                 for f in sd.fields})
        raise TypeError(f"no zero value for {b}")

    def _convert(self, val, ty: TypeName):
        """Coerce a call argument / literal to a declared type."""
        if ty.dims:
            return val
        b = ty.base
        m = _BYTES_RE.match(b)
        if m:
            n = int(m.group(1))
            if isinstance(val, str):
                raw = val.encode()
                assert len(raw) <= n, "string literal too long"
                return raw.ljust(n, b"\x00")
            if isinstance(val, int):
                return val.to_bytes(n, "big")
            return val
        if _UINT_RE.match(b):
            if isinstance(val, bytes):
                return int.from_bytes(val, "big")
            bits = int(_UINT_RE.match(b).group(1) or 256)
            return int(val) & ((1 << bits) - 1)
        if b in self.value_types and isinstance(val, int) and \
                not isinstance(val, bool):
            # implicit only via wrap(); literals shouldn't coerce, but
            # fixtures may pass raw ints for convenience
            return Wrapped(b, val)
        return val

    # -- function invocation --
    def _call_fn(self, fn: FuncDecl, args: list):
        env = {"__lib": fn.lib}
        assert len(args) == len(fn.params), \
            f"{fn.name}: want {len(fn.params)} args, got {len(args)}"
        for p, a in zip(fn.params, args):
            env[p.name] = self._convert(a, p.type)
        for r in fn.rets:
            if r.name:
                env[r.name] = self._zero(r.type)
        try:
            for st in fn.body:
                self._exec(st, env)
        except _Return as ret:
            if ret.value is not None:
                return ret.value
        # implicit return of named returns
        if fn.rets and all(r.name for r in fn.rets):
            vals = tuple(env[r.name] for r in fn.rets)
            return vals[0] if len(vals) == 1 else vals
        return None

    # -- statements --
    def _exec(self, st, env):
        k = st[0]
        if k == "block":
            for s in st[1]:
                self._exec(s, env)
        elif k == "expr":
            self._eval(st[1], env)
        elif k == "decl":
            targets, rhs = st[1], st[2]
            val = self._eval_rhs(rhs, env) if rhs is not None else None
            if len(targets) == 1:
                ty, name = targets[0]
                v = self._zero(ty) if val is None else (
                    self._convert(val, ty) if ty else val)
                self._store(name, v, env)
            else:
                vals = val if isinstance(val, tuple) else (val,)
                assert len(vals) == len(targets), "tuple arity mismatch"
                for (ty, name), v in zip(targets, vals):
                    self._store(name, self._convert(v, ty) if ty else v, env)
        elif k == "assign":
            op, lv, rhs = st[1], st[2], st[3]
            val = self._eval_rhs(rhs, env)
            if op != "=":
                cur = self._eval(lv, env)
                val = self._binop(op[:-1], cur, val, env)
            if isinstance(val, tuple) and lv[0] == "tuple":
                for tgt, v in zip(lv[1], val):
                    self._store_lvalue(tgt, v, env)
            else:
                self._store_lvalue(lv, val, env)
        elif k == "postfix":
            op, lv = st[1], st[2]
            cur = self._eval(lv, env)
            self._store_lvalue(lv, cur + (1 if op == "++" else -1), env)
        elif k == "if":
            if self._truthy(self._eval(st[1], env)):
                self._exec(st[2], env)
            elif st[3] is not None:
                self._exec(st[3], env)
        elif k == "for":
            inner = dict(env)
            if st[1] is not None:
                self._exec(st[1], inner)
            while st[2] is None or self._truthy(self._eval(st[2], inner)):
                self._exec(st[4], inner)
                if st[3] is not None:
                    self._exec(st[3], inner)
            for key in env:
                env[key] = inner[key]
        elif k == "return":
            raise _Return(None if st[1] is None
                          else self._eval_rhs(st[1], env))
        elif k == "require":
            if not self._truthy(self._eval(st[1], env)):
                msg = self._eval(st[2], env) if st[2] is not None else ""
                raise SolidityRevert(msg)
        elif k == "revert":
            msg = self._eval(st[1], env) if st[1] is not None else ""
            raise SolidityRevert(msg)
        else:
            raise RuntimeError(f"unknown stmt {k}")

    def _eval_rhs(self, e, env):
        if e[0] == "tuple":
            return tuple(self._eval(x, env) for x in e[1])
        return self._eval(e, env)

    def _store(self, name_or_lv, val, env):
        if isinstance(name_or_lv, str):
            env[name_or_lv] = val
        else:
            self._store_lvalue(name_or_lv, val, env)

    def _store_lvalue(self, lv, val, env):
        k = lv[0]
        if k == "ident":
            env[lv[1]] = val
        elif k == "member":
            obj = self._eval(lv[1], env)
            obj[lv[2]] = val
        elif k == "index":
            obj = self._eval(lv[1], env)
            obj[self._eval(lv[2], env)] = val
        else:
            raise RuntimeError(f"bad lvalue {lv}")

    @staticmethod
    def _truthy(v) -> bool:
        if isinstance(v, bool):
            return v
        if isinstance(v, int):
            return v != 0
        raise TypeError(f"non-boolean condition: {v!r}")

    # -- expressions --
    def _eval(self, e, env):
        k = e[0]
        if k == "num":
            return e[1]
        if k == "str":
            return e[1]          # converted at use sites
        if k == "bool":
            return e[1]
        if k == "ident":
            return self._lookup(e[1], env)
        if k == "ternary":
            return self._eval(e[2] if self._truthy(self._eval(e[1], env))
                              else e[3], env)
        if k == "un":
            v = self._eval(e[2], env)
            if e[1] == "!":
                return not self._truthy(v)
            if e[1] == "-":
                return (-v) % (1 << 256)
            if e[1] == "~":
                return v ^ ((1 << 256) - 1)
        if k == "bin":
            left = self._eval(e[2], env)
            if e[1] == "&&":
                return self._truthy(left) and \
                    self._truthy(self._eval(e[3], env))
            if e[1] == "||":
                return self._truthy(left) or \
                    self._truthy(self._eval(e[3], env))
            return self._binop(e[1], left, self._eval(e[3], env), env)
        if k == "tuple":
            return tuple(self._eval(x, env) for x in e[1])
        if k == "arrlit":
            return [self._eval(x, env) for x in e[1]]
        if k == "new_arr":
            n = self._eval(e[2], env)
            inner = TypeName(e[1].base, e[1].dims[1:])
            return [self._zero(inner) for _ in range(n)]
        if k == "index":
            return self._eval(e[1], env)[self._eval(e[2], env)]
        if k == "member":
            return self._member(e, env)
        if k == "call":
            return self._call(e, env)
        raise RuntimeError(f"unknown expr {k}")

    def _lookup(self, name, env):
        if name in env:
            return env[name]
        if name in self.consts:
            return self.consts[name]
        lib = env.get("__lib")
        if lib and name in self.libraries[lib].consts:
            return self.libraries[lib].consts[name][1]
        if lib and name in self.libraries[lib].funcs:
            return ("__boundlib", lib, name, None)
        if lib and name in self.libraries[lib].structs:
            return ("__structref", f"{lib}.{name}")
        if name in self.libraries:
            return ("__libref", name)
        if name in self.value_types:
            return ("__typeref", name)
        if name in self.structs:
            return ("__structref", name)
        if name in self.free_funcs:
            return ("__funcref", name)
        raise NameError(name)

    def _member(self, e, env):
        _, obj_e, name = e
        # qualified library access without evaluating as value
        obj = self._eval(obj_e, env)
        if isinstance(obj, tuple) and obj and obj[0] == "__libref":
            lib = self.libraries[obj[1]]
            if name in lib.consts:
                return lib.consts[name][1]
            if name in lib.funcs:
                return ("__boundlib", obj[1], name, None)
            if name in lib.structs:
                return ("__structref", f"{obj[1]}.{name}")
            raise NameError(f"{obj[1]}.{name}")
        if isinstance(obj, tuple) and obj and obj[0] == "__typeref":
            return ("__typemember", obj[1], name)
        if isinstance(obj, (list, bytes)) and name == "length":
            return len(obj)
        if isinstance(obj, StructVal):
            if name in obj:
                return obj[name]
            return self._method_ref(obj, obj.typename, name)
        if isinstance(obj, Wrapped):
            return self._method_ref(obj, obj.type, name)
        if isinstance(obj, int):
            # address(0xN).staticcall
            if name == "staticcall":
                return ("__staticcall", obj)
        raise NameError(f"member {name} of {obj!r}")

    def _method_ref(self, obj, typename, name):
        for lib in self.using_for.get(typename, []):
            if name in self.libraries[lib].funcs:
                return ("__boundlib", lib, name, obj)
        raise NameError(f"method {name} on {typename}")

    def _call(self, e, env):
        _, callee, arg_es = e
        # builtins by name
        if callee[0] == "ident":
            name = callee[1]
            if name == "keccak256":
                from ..utils.keccak import keccak256
                data = self._eval(arg_es[0], env)
                assert isinstance(data, bytes)
                return keccak256(data)
            if name == "addmod":
                a, b, m = (self._eval(x, env) for x in arg_es)
                return (a + b) % m
            if name == "mulmod":
                a, b, m = (self._eval(x, env) for x in arg_es)
                return (a * b) % m
            if name == "address":
                return self._eval(arg_es[0], env)
            if _UINT_RE.match(name):
                bits = int(_UINT_RE.match(name).group(1) or 256)
                v = self._eval(arg_es[0], env)
                if isinstance(v, bytes):
                    v = int.from_bytes(v, "big")
                if isinstance(v, Wrapped):
                    raise TypeError("explicit unwrap required")
                return v & ((1 << bits) - 1)
            if _BYTES_RE.match(name):
                n = int(_BYTES_RE.match(name).group(1))
                v = self._eval(arg_es[0], env)
                if isinstance(v, str):
                    return v.encode().ljust(n, b"\x00")
                if isinstance(v, int):
                    return v.to_bytes(n, "big")
                return v
        if callee[0] == "member":
            # abi.encode / abi.encodePacked / abi.decode
            if callee[1] == ("ident", "abi"):
                return self._abi(callee[2], arg_es, env)
            obj = self._member(callee, env)
            return self._apply(obj, arg_es, env)
        obj = self._eval(callee, env)
        return self._apply(obj, arg_es, env)

    def _apply(self, obj, arg_es, env):
        args = [self._eval(a, env) for a in arg_es]
        if isinstance(obj, tuple):
            tag = obj[0]
            if tag == "__boundlib":
                _, lib, fname, self_obj = obj
                fn = self.libraries[lib].funcs[fname]
                if self_obj is not None:
                    args = [self_obj] + args
                return self._call_fn(fn, args)
            if tag == "__funcref":
                return self._call_fn(self.free_funcs[obj[1]], args)
            if tag == "__typemember":
                _, tname, m = obj
                if m == "wrap":
                    return Wrapped(tname, args[0])
                if m == "unwrap":
                    assert isinstance(args[0], Wrapped)
                    return args[0].val
                raise NameError(f"{tname}.{m}")
            if tag == "__structref":
                sd = self.structs[obj[1]]
                assert len(args) == len(sd.fields)
                return StructVal(obj[1], {
                    f.name: self._convert(a, f.type)
                    for f, a in zip(sd.fields, args)})
            if tag == "__staticcall":
                addr = obj[1]
                data = args[0]
                try:
                    return (True, PRECOMPILES[addr](data))
                except Exception:
                    return (False, b"")
        raise TypeError(f"not callable: {obj!r}")

    def _abi(self, which, arg_es, env):
        if which == "decode":
            data = self._eval(arg_es[0], env)
            # second arg is a type tuple: ("tuple", [...]) or single type
            types = arg_es[1]
            names = ([t[1] for t in types[1]] if types[0] == "tuple"
                     else [types[1]])
            vals = []
            for i, tn in enumerate(names):
                word = data[32 * i: 32 * (i + 1)]
                if _BYTES_RE.match(tn):
                    vals.append(word)
                else:
                    vals.append(int.from_bytes(word, "big"))
            return vals[0] if len(vals) == 1 else tuple(vals)
        packed = which == "encodePacked"
        out = b""
        for a_e in arg_es:
            v = self._eval(a_e, env)
            out += self._abi_word(v, packed)
        return out

    def _abi_word(self, v, packed: bool) -> bytes:
        if isinstance(v, bytes):
            return v
        if isinstance(v, str):
            return v.encode()
        if isinstance(v, Wrapped):
            v = v.val
        if isinstance(v, bool):
            v = int(v)
        if isinstance(v, int):
            return v.to_bytes(32, "big")
        if isinstance(v, list):          # fixed-size arrays in abi.encode
            return b"".join(self._abi_word(x, packed) for x in v)
        raise TypeError(f"cannot abi-encode {v!r}")

    # -- operators --
    def _binop(self, op, a, b, env):
        wa = isinstance(a, Wrapped)
        wb = isinstance(b, Wrapped)
        if wa or wb:
            t = a.type if wa else b.type
            binding = self.op_bindings.get(t, {})
            if op in binding:
                return self._call_fn(binding[op], [a, b])
            if op in ("==", "!="):
                eq = wa and wb and a.val == b.val
                return eq if op == "==" else not eq
            raise TypeError(f"no operator {op} for {t}")
        if isinstance(a, bytes) or isinstance(b, bytes):
            if op == "==":
                return a == b
            if op == "!=":
                return a != b
            raise TypeError(f"bytes operator {op}")
        M = (1 << 256) - 1
        if op == "+":
            r = a + b
            assert r <= M, "uint256 overflow"
            return r
        if op == "-":
            assert a >= b, "uint256 underflow"
            return a - b
        if op == "*":
            r = a * b
            assert r <= M, "uint256 overflow"
            return r
        if op == "/":
            return a // b
        if op == "%":
            return a % b
        if op == "**":
            return pow(a, b)
        if op == "<<":
            return (a << b) & M
        if op == ">>":
            return a >> b
        if op == "&":
            return a & b
        if op == "|":
            return a | b
        if op == "^":
            return a ^ b
        if op == "==":
            return a == b
        if op == "!=":
            return a != b
        if op == "<":
            return a < b
        if op == ">":
            return a > b
        if op == "<=":
            return a <= b
        if op == ">=":
            return a >= b
        raise RuntimeError(f"unknown op {op}")


_DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))),
    "evm_verifier", "src", "subprotocols")

_vm_cache: dict[str, SolidityVM] = {}


def load_vm(src_dir: str = _DEFAULT_DIR) -> SolidityVM:
    if src_dir not in _vm_cache:
        _vm_cache[src_dir] = SolidityVM(src_dir)
    return _vm_cache[src_dir]
