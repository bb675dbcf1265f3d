"""Count a kernel's instructions per thread from its SASS.

    python -m vpt_tpu_torch.tools.sass_count LIB_OR_DUMP [...]
        [--kernel SUBSTRING ...] [--trips SUBSTRING=16,8 ...]
        [--save DIR] [--against OLD_LIB_OR_DUMP]

Each argument is a built kernel library (a ``.so``, disassembled with
``cuobjdump -sass``, which the CUDA toolkit has) or a text file holding
such a disassembly (``--save`` writes one per library).  For every
function whose mangled name holds one of the ``--kernel`` substrings
(default: the environment and primary-ray kernels), prints one JSON line:
the static instruction count, the loops (a backward branch closes one),
and the instructions one thread issues, by class (``mufu`` by kind,
``int``, ``float``, ``memory``, ``control``, ``other``): every
instruction outside a loop once, each instruction inside loops the
product of their trip counts, given outermost first by ``--trips`` for
the kernels whose name holds the substring (a loop without a given trip
count counts once, and the line says so).  Out-of-line subroutines (the
targets of CALL: IEEE division's and square root's slow paths) are left
out, and so are the basic blocks that call them (with a lone branch
back after the call): those run only on the slow paths.  Every other
instruction counts, so ``per_thread`` is that of a thread that runs
every instruction outside those slow paths (``per_thread_all`` counts
the calling blocks too).  ``text_sha256`` hashes the function's
instructions (address, opcode and operands): two builds whose code is the
same give the same hash.  ``--against`` adds ``same_as_against``: whether
the function of the same name (``common_name``) in another build has the
same hash (None where that build has no such function).  ``loads``
counts the global loads (LDG) outside the slow paths by opcode, each
once, and ``ldg_in_flight`` places them: for each, the loads issued from
it to the first instruction that reads what it loaded, in program order
(1 where that instruction follows it before any other load), its mean
and its largest value.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

KERNELS = ("environment_kernel", "atmosphere_kernel",
           "primary_rays_kernel")
INT_OPS = ("IADD", "IMAD", "LOP", "SHF", "ISETP", "LEA", "IABS", "IMNMX",
           "POPC", "FLO", "PRMT", "SEL", "SGXT", "BMSK", "BREV", "IDP",
           "VIADD", "VIMNMX", "IMUL", "USHF", "ULOP", "UIADD", "UIMAD",
           "ULEA", "USEL", "UPRMT")
FLOAT_OPS = ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FSET",
             "FCHK", "FSWZADD", "FRND")
MEMORY_OPS = ("LD", "ST", "ATOM", "RED", "LDC", "ULDC", "LDS", "STS",
              "LDG", "STG", "LDL", "STL", "CCTL")
CONTROL_OPS = ("BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "BAR",
               "WARPSYNC", "BPT", "YIELD", "NANOSLEEP", "JMP", "BRX")

_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s*(.*?)\s*;")
_LABEL = re.compile(r"^\s*([^\s/][^\s]*):\s*$")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_TARGET = re.compile(r"`\(([^)]+)\)")
_PRED = re.compile(r"^@!?U?P(?:[0-9]|T)\s+")
_REG = re.compile(r"\bR(\d+)(\.64)?\b")
_NO_DEST = ("ST", "RED", "ATOM", "BRA", "EXIT", "CALL", "RET", "BAR")


def disassemble(path: str) -> str:
    """cuobjdump -sass of a library, or the text of a saved dump."""
    if not path.endswith(".so"):
        with open(path) as f:
            return f.read()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=600).stdout


def functions(text: str) -> dict:
    """{mangled name: ([(address, opcode, operands)], {label: address})}:
    a label names the address of the instruction that follows it."""
    out, name, pending = {}, None, []
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            name, pending = m.group(1), []
            out[name] = ([], {})
            continue
        if name is None:
            continue
        m = _INSN.match(line)
        if m:
            addr = int(m.group(1), 16)
            body = _PRED.sub("", m.group(2).strip())
            op, _, rest = body.partition(" ")
            out[name][0].append((addr, op, rest))
            for lab in pending:
                out[name][1][lab] = addr
            pending = []
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
    return out


def common_name(name: str) -> str:
    """A kernel's name across builds of the sources: the anonymous
    namespace's per-source hash dropped; K1's deferred-environment
    template argument read as an int (a bool before env_pos: the same 0
    and 1); K1's row arguments and its parameter list dropped where they
    are float32 rows without the octant branch (their defaults: the older
    builds had no such arguments, and the corner rows' parameter mangles
    as the row argument); K4's parameter list dropped (the atmosphere
    kinds appended arguments to it); K5's parameter lists dropped, with
    its scene and sky kinds where they are a single grid's float32 rows
    without octant columns under the run-time sky (0: the older builds
    had neither argument, and the scene struct appended an argument)."""
    name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", name)
    name = re.sub(r"(walk_(?:direct|extend|scatter)_kernelILb[01]E)"
                  r"(?:Li0E)?E.*", r"\1E", name)
    name = re.sub(r"(walk_nee_kernel)(?:ILi0ELi0EE|E).*", r"\1", name)
    name = re.sub(r"(walk_keys_kernelILb[01]EE).*", r"\1", name)
    name = re.sub(r"(fused_direct_kernelILb[01]E)Lb([01])E", r"\1Li\2E",
                  name)
    name = re.sub(r"(fused_direct_kernelI(?:L[bi]\d+E){4})(?:fLb0E)?E.*",
                  r"\1E", name)
    return re.sub(r"(environment_kernelILi\d+E).*", r"\1", name)


def _sha(insns) -> str:
    return hashlib.sha256("\n".join(
        f"{a:x} {op} {r}" for a, op, r in insns).encode()).hexdigest()


def _target(rest: str, labels: dict):
    m = _TARGET.search(rest)
    if m:
        return labels.get(m.group(1))
    m = re.search(r"0x([0-9a-f]+)", rest)
    return int(m.group(1), 16) if m else None


def classify(op: str) -> str:
    base = op.split(".")[0]
    if base == "MUFU":
        return op
    for cls, names in (("control", CONTROL_OPS), ("memory", MEMORY_OPS),
                       ("float", FLOAT_OPS), ("int", INT_OPS)):
        if base in names or (cls == "int" and base.startswith(names)):
            return cls
    return "other"


def _cold(body, labels):
    """Addresses of the basic blocks that call a subroutine, each with a
    block after it that holds only a branch."""
    targets = {_target(r, labels) for _, op, r in body if op == "BRA"}
    blocks, cur = [], []
    for a, op, r in body:
        if cur and a in targets:
            blocks.append(cur)
            cur = []
        cur.append((a, op))
        if op in ("BRA", "EXIT") or op.startswith(("CALL", "RET")):
            blocks.append(cur)
            cur = []
    if cur:
        blocks.append(cur)
    cold = set()
    for i, blk in enumerate(blocks):
        if any(op.startswith("CALL") for _, op in blk):
            cold.update(a for a, _ in blk)
            nxt = blocks[i + 1] if i + 1 < len(blocks) else []
            if len(nxt) == 1 and nxt[0][1] == "BRA":
                cold.add(nxt[0][0])
    return cold


def _regs(text: str) -> set:
    out = set()
    for m in _REG.finditer(text):
        r = int(m.group(1))
        out.update((r, r + 1) if m.group(2) else (r,))
    return out


def _sources(op: str, rest: str) -> set:
    """The general registers an instruction reads: every one in its
    operands but a leading destination register."""
    if op.startswith(_NO_DEST) or not re.match(r"\s*R\d", rest):
        return _regs(rest)
    return _regs(rest.split(",", 1)[1] if "," in rest else "")


def ldg_in_flight(body) -> list:
    """For each LDG of ``body`` ([(address, opcode, operands)] in program
    order): the LDGs from it to the first instruction that reads one of
    its destination registers, itself included."""
    out = []
    for k, (_, op, rest) in enumerate(body):
        if not op.startswith("LDG"):
            continue
        m = re.match(r"\s*R(\d+)", rest)
        if not m:
            continue
        width = 4 if ".128" in op else 2 if ".64" in op else 1
        dest = set(range(int(m.group(1)), int(m.group(1)) + width))
        n = 1
        for _, op2, rest2 in body[k + 1:]:
            if _sources(op2, rest2) & dest:
                break
            n += op2.startswith("LDG")
        out.append(n)
    return out


def count(insns, labels, trips=()):
    """The per-thread counts of one function (see the module doc)."""
    calls = {_target(r, labels) for _, op, r in insns if op.startswith("CALL")}
    calls.discard(None)
    end = min(calls) if calls else None
    body = [(a, op, r) for a, op, r in insns
            if (end is None or a < end) and op != "NOP"
            and not (op == "BRA" and _target(r, labels) == a)]
    cold = _cold(body, labels)
    loops = sorted({(_target(r, labels), a) for a, op, r in body
                    if op == "BRA" and _target(r, labels) is not None
                    and _target(r, labels) < a},
                   key=lambda l: (l[0], -l[1]))
    given = list(trips) + [None] * (len(loops) - len(trips))
    weights = {}
    for a, op, r in body:
        w = 1
        for (lo, hi), t in zip(loops, given):
            if lo <= a <= hi and t is not None:
                w *= t
        weights[a] = w
    per_class, mufu = {}, {}
    for a, op, r in body:
        if a in cold:
            continue
        c = classify(op)
        if c.startswith("MUFU"):
            mufu[c] = mufu.get(c, 0) + weights[a]
            c = "mufu"
        per_class[c] = per_class.get(c, 0) + weights[a]
    depth = [sum(1 for lo2, hi2 in loops if lo2 <= lo and hi <= hi2)
             for lo, hi in loops]
    hot = [(a, op, r) for a, op, r in body if a not in cold]
    loads = {}
    for _, op, _ in hot:
        if op.startswith("LDG"):
            loads[op] = loads.get(op, 0) + 1
    flight = ldg_in_flight(hot)
    return dict(
        static=len(body), subroutine_insns=len(insns) - len(body),
        slow_path_call_insns=len(cold),
        loops=[dict(start=hex(lo), end=hex(hi), depth=d,
                    static=sum(1 for a, _, _ in body if lo <= a <= hi),
                    mufu_static=sum(1 for a, op, _ in body
                                    if lo <= a <= hi and op.startswith("MUFU")),
                    trips=t)
               for (lo, hi), d, t in zip(loops, depth, given)],
        trips_missing=sum(t is None for t in given),
        per_thread=sum(w for a, w in weights.items() if a not in cold),
        per_thread_all=sum(weights.values()), by_class=per_class, mufu=mufu,
        loads=loads, ldg_in_flight=dict(
            mean=sum(flight) / len(flight) if flight else 0.0,
            max=max(flight, default=0)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("paths", nargs="+")
    ap.add_argument("--kernel", nargs="+", default=list(KERNELS))
    ap.add_argument("--trips", nargs="*", default=[],
                    help="SUBSTRING=N,M: the trip counts of the loops of "
                         "the kernels whose name holds SUBSTRING")
    ap.add_argument("--save", default=None,
                    help="directory for each library's disassembly")
    ap.add_argument("--against", default=None,
                    help="another build: compare each kernel's text_sha256")
    args = ap.parse_args(argv)
    against = None
    if args.against:
        against = {common_name(n): _sha(insns) for n, (insns, _) in
                   functions(disassemble(args.against)).items()}
    trips = {}
    for t in args.trips:
        key, _, val = t.partition("=")
        trips[key] = [int(v) for v in val.split(",") if v]
    for i, path in enumerate(args.paths):
        text = disassemble(path)
        if args.save and path.endswith(".so"):
            os.makedirs(args.save, exist_ok=True)
            with open(os.path.join(args.save, f"sass_{i}.txt"), "w") as f:
                f.write(text)
        for name, (insns, labels) in functions(text).items():
            if not any(k in name for k in args.kernel):
                continue
            t = next((v for k, v in trips.items() if k in name), [])
            sha = _sha(insns)
            rec = {"source": path, "kernel": name,
                   **count(insns, labels, t), "text_sha256": sha}
            if against is not None:
                old = against.get(common_name(name))
                rec["same_as_against"] = None if old is None else old == sha
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
