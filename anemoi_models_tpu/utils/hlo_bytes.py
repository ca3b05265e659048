"""HBM-traffic accounting from optimized HLO.

``cost_analysis()['bytes accessed']`` counts every HLO op's operands and
results BEFORE fusion — elementwise intermediates that fusion never
materializes are charged anyway, which can put a measured time above
100% of roofline. The defensible
estimate reads the *optimized* module: after fusion, each top-level
instruction of the entry computation reads its operands from HBM and writes
its result once — for tensors far larger than on-chip memory (this
model's node/slot tensors are tens of MB) that IS the executed traffic
schedule. The parser was written for another backend's scheduled HLO and
has not been validated against GPU HLO (custom calls to cuBLAS/cuDNN,
Triton fusions), so on the GPU its count is a rough placement only.

Two refinements keep the estimate on the right side of physics (a plain
post-fusion count put a train step above 100% of roofline):

- **windowed ops** (gather / dynamic-slice / slice) read only a
  result-sized window of their first operand, so they are charged
  2 x result + index operands, and dynamic-update-slice executes in place
  (one read + one write of the update window);
- **fusion operands are charged by how the fused computation consumes
  them**: a parameter consumed exclusively by windowed ops (the bucketed
  gather-from-table pattern that dominates this model's backward) is
  charged at the windows' result bytes, not the full table.

``hbm_bytes(compiled_text)`` sums these over the entry computation,
skipping parameters/constants (reads are charged at the consumer) and pure
layout/bookkeeping ops (tuple/get-tuple-element/bitcast — no data
movement). ``while``/``call``/``conditional`` bodies are not walked —
their operands are charged in full (conservative).
"""

from __future__ import annotations

import re
from typing import Optional

__all__ = ["hbm_bytes"]

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

# one typed shape, e.g. bf16[40320,256]{1,0}
_SHAPE = re.compile(r"(\w+)\[([0-9,]*)\]")
# operand references inside the parens: %name
_OPERAND = re.compile(r"%([\w.-]+)")
_OPCODE = re.compile(r"[\w-]+$")
_NAME = re.compile(r"[\w.-]+")
_CALLS = re.compile(r"calls=%?([\w.-]+)")
# a computation header: "[ENTRY] %name (...) -> ... {" at top level
_COMP_HEADER = re.compile(r"^(?:ENTRY\s+)?%?([\w.-]+)\s*\([^\n]*\{\s*$", re.M)

# no HBM data movement of their own
_FREE_OPS = {
    "parameter", "constant", "tuple", "get-tuple-element", "bitcast",
    "after-all", "partition-id", "replica-id", "iota",
}
# read only a result-sized window of operand 0
_WINDOWED_OPS = {"gather", "dynamic-slice", "slice"}


def _shape_bytes(text: str) -> int:
    total = 0
    for dtype, dims in _SHAPE.findall(text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _parse_line(line: str):
    """Parse "[ROOT] %name = <shape> opcode(operands...), tail" into
    ``(name, result_bytes, opcode, operands, tail)`` or None.

    Hand-parsed: scheduled modules may annotate shapes with layout/tiling
    text (e.g. ``bf16[1024,1024]{1,0:T(8,128)(2,1)S(1)}``) that a
    shape-charset regex cannot anticipate. The shape token is either a
    parenthesized tuple or a single space-free token; the opcode is the
    next token, ending at its argument paren.
    """
    line = line.strip()
    if line.startswith("ROOT "):
        line = line[5:]
    eq = line.find(" = ")
    if eq < 0:
        return None
    name = line[:eq].strip().lstrip("%")
    if not _NAME.fullmatch(name):
        return None
    rhs = line[eq + 3 :]
    if rhs.startswith("("):  # tuple shape: ends at the matching paren
        depth, shape_end = 0, -1
        for i, ch in enumerate(rhs):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    shape_end = i + 1
                    break
        if shape_end < 0:
            return None
    else:
        shape_end = rhs.find(" ")
        if shape_end < 0:
            return None
    shape_text = rhs[:shape_end]
    rest = rhs[shape_end:].lstrip()
    paren = rest.find("(")
    if paren < 0 or not _OPCODE.match(rest[:paren]):
        return None
    opcode = rest[:paren]
    # operand list ends at the first depth-0 ')' (metadata/backend-config
    # tails follow)
    args = rest[paren + 1 :]
    depth, cut = 1, len(args)
    for i, ch in enumerate(args):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                cut = i
                break
    operands = _OPERAND.findall(args[:cut])
    return name, _shape_bytes(shape_text), opcode, operands, args[:cut], args[cut:]


def _computations(hlo_text: str) -> dict[str, list]:
    """Split the module into computations: name -> parsed instruction list."""
    comps: dict[str, list] = {}
    header = None
    body: list = []
    for line in hlo_text.splitlines():
        if header is not None and line.startswith("}"):
            comps[header] = body
            header, body = None, []
            continue
        m = _COMP_HEADER.match(line)
        if m is not None:
            header, body = m.group(1), []
            if line.lstrip().startswith("ENTRY") or line.startswith("ENTRY"):
                comps["__entry__"] = body
            continue
        if header is not None:
            parsed = _parse_line(line)
            if parsed is not None:
                body.append(parsed)
    return comps


def _fused_param_windows(instrs: list) -> dict[int, Optional[int]]:
    """For each parameter index of a fused computation: the total window
    bytes it is read through, or None when any consumer reads it fully.

    A parameter consumed exclusively as operand 0 of windowed ops (gather /
    dynamic-slice / slice) costs only those ops' result bytes in HBM
    traffic; any other use means the fusion streams the whole operand.
    """
    idx_of: dict[str, int] = {}
    for name, _nbytes, opcode, _operands, rawargs, _tail in instrs:
        if opcode != "parameter":
            continue
        digits = rawargs.strip()
        if digits.isdigit():
            idx_of[name] = int(digits)
    windows: dict[int, Optional[int]] = {}
    for pname, pidx in idx_of.items():
        acc: Optional[int] = 0
        for _name, nbytes, opcode, operands, _rawargs, _tail in instrs:
            if opcode == "parameter" or pname not in operands:
                continue
            if opcode in _WINDOWED_OPS and operands and operands[0] == pname \
                    and operands.count(pname) == 1:
                acc = (acc or 0) + nbytes
            else:
                acc = None
                break
        windows[pidx] = acc
    return windows


def hbm_bytes(hlo_text: str) -> int:
    """Estimated HBM bytes moved by one execution of the optimized module."""
    if re.search(r"^ENTRY\b", hlo_text, re.M) is None:
        raise ValueError("no ENTRY computation in HLO text")
    comps = _computations(hlo_text)
    entry = comps.get("__entry__")
    if not entry:
        raise ValueError("no ENTRY computation in HLO text")

    window_cache: dict[str, dict[int, Optional[int]]] = {}
    shapes: dict[str, int] = {}
    total = 0
    for name, nbytes, opcode, operands, _rawargs, tail in entry:
        shapes[name] = nbytes
        if opcode in _FREE_OPS:
            continue
        if opcode == "copy-start":
            # async copy pair (e.g. cross-program prefetch of a parameter):
            # one read + one write of the copied tensor, charged here; the
            # matching *-done is free. The tuple result shape repeats the
            # buffer (src + dst + context) — charging it would triple-count.
            moved = shapes.get(operands[0], 0) if operands else 0
            total += 2 * moved
            shapes[name] = 0  # the -done's operand read is not a re-read
            continue
        if opcode.endswith("-done"):
            continue  # traffic charged at the matching *-start
        if opcode in _WINDOWED_OPS:
            # reads a result-sized window of the (possibly huge) operand 0:
            # charge result write + window read + the index operands — a
            # train step full of remat/adjoint-chunk slices reported 116%
            # of roofline when these were charged in full
            total += 2 * nbytes
            for op_name in operands[1:]:
                total += shapes.get(op_name, 0)
            continue
        if opcode == "dynamic-update-slice":
            # executes in place (result aliases the operand): traffic is one
            # read + one write of the update window, not the full tensor
            upd = shapes.get(operands[1], 0) if len(operands) > 1 else 0
            total += 2 * upd
            continue
        if opcode == "fusion":
            m = _CALLS.search(tail)
            called = comps.get(m.group(1)) if m else None
            if called is not None:
                key = m.group(1)
                if key not in window_cache:
                    window_cache[key] = _fused_param_windows(called)
                windows = window_cache[key]
                total += nbytes  # result write
                for i, op_name in enumerate(operands):
                    w = windows.get(i)
                    full = shapes.get(op_name, 0)
                    # charge the windowed read where the fused computation
                    # only gathers/slices this operand (never more than the
                    # full tensor)
                    total += full if w is None else min(w, full)
                continue
        total += nbytes  # one result write
        for op_name in operands:
            total += shapes.get(op_name, 0)
    return total
