"""What ``chip_smoke.py`` reports about the fused score kernels, off their
runtime path: the instruction counts of a built kernel's sample loops, and
the work the fused sweep does on given inputs.

The card's machine has no ``ncu``, so the instruction side of a kernel's
bound is read from the compiled code instead: ``cuobjdump -sass`` of the
library ``kernels._build`` made, parsed here into each kernel's innermost
loops (a backward branch and the instructions it jumps over).
``sample_loop`` picks the loop with the most ``MUFU.EX2`` and scales its
counts to one element by the EX2 instructions one element needs (libdevice's
``expf`` is one EX2), which also undoes any unrolling by the compiler. Of
its instructions only the FP32 arithmetic (``FP32_OPS``) and the MUFU ones
are work the math needs; loads, integer address arithmetic, moves and loop
control are left out of the bound.

``live_tiles`` and ``sweep_chunks`` restate the sweep's skip rule (a tile
with no live pair stages nothing, a dataset's loop stops at its valid count)
to count the tiles and sample chunks a launch sweeps; the card tests hold
the rule against the kernel.

Pure text and torch CPU work: only ``dump`` needs the CUDA toolkit.
"""

from __future__ import annotations

import re
import subprocess
from collections import Counter
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels.fused_score import BLOCK_N, tile_maps

#: SASS opcodes of FP32 arithmetic, each one instruction of an FP32 lane.
FP32_OPS = frozenset({"FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "FSET", "FRND"})

_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")


@dataclass(frozen=True)
class Loop:
    """An innermost loop: its address range and its opcodes (no NOPs)."""

    start: int
    end: int
    ops: tuple[str, ...]

    def count(self, prefix: str) -> int:
        return sum(op.startswith(prefix) for op in self.ops)

    def fp32(self) -> int:
        return sum(op.split(".")[0] in FP32_OPS for op in self.ops)

    def histogram(self) -> Counter:
        return Counter(op.split(".")[0] for op in self.ops)


@dataclass(frozen=True)
class LoopCounts:
    """Instructions per element of a sample loop: all of them, the FP32
    arithmetic ones and the MUFU ones; ``loop`` is the loop they come from."""

    instructions: float
    fp32: float
    mufu: float
    loop: Loop


def dump(library: str | Path) -> str:
    """``cuobjdump -sass`` of a built library, from the toolkit beside nvcc."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def functions(sass: str) -> dict[str, list[tuple[int, str]]]:
    """Each function's instructions as (address, text without predicate
    guard), keyed by its (mangled) name; label lines become entries
    ``(address of the next instruction, ".L_x_N:")``."""
    out: dict[str, list[tuple[int, str]]] = {}
    cur = None
    pending: list[str] = []
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            pending = []
            continue
        if cur is None:
            continue
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        ins = _INSN.search(line)
        if ins:
            addr = int(ins.group(1), 16)
            cur.extend((addr, f"{name}:") for name in pending)
            pending = []
            cur.append((addr, re.sub(r"^@!?U?P\w+\s+", "", ins.group(2))))
    return out


def innermost_loops(insns: list[tuple[int, str]]) -> list[Loop]:
    """Loops closed by a backward ``BRA`` that contain no other such loop."""
    labels = {text[:-1]: addr for addr, text in insns if text.endswith(":")}
    code = [(addr, text) for addr, text in insns if not text.endswith(":")]
    edges = []
    for addr, text in code:
        if text.split()[0].split(".")[0] != "BRA":
            continue
        m = _TARGET.search(text)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is not None and target <= addr:
            edges.append((target, addr))
    inner = [(s, e) for s, e in edges
             if not any((s2, e2) != (s, e) and s <= s2 and e2 <= e for s2, e2 in edges)]
    return [Loop(s, e, tuple(text.split()[0] for addr, text in code
                             if s <= addr <= e and not text.startswith("NOP")))
            for s, e in sorted(set(inner))]


def sample_loop(sass: str, kernel: str, ex2_per_element: int) -> LoopCounts:
    """The counts per element of the innermost loop of the function whose
    name contains ``kernel`` that runs the most ``MUFU.EX2``;
    ``ex2_per_element`` EX2 make one element."""
    funcs = [v for k, v in functions(sass).items() if kernel in k]
    if len(funcs) != 1:
        raise ValueError(f"{len(funcs)} functions named like {kernel!r} in the SASS")
    loops = innermost_loops(funcs[0])
    if not loops:
        raise ValueError(f"no loop in {kernel!r}")
    loop = max(loops, key=lambda lp: lp.count("MUFU.EX2"))
    ex2 = loop.count("MUFU.EX2")
    if ex2 == 0 or ex2 % ex2_per_element:
        raise ValueError(f"{kernel!r}: {ex2} EX2 in its busiest loop, not a multiple "
                         f"of {ex2_per_element}")
    per = ex2 // ex2_per_element
    return LoopCounts(len(loop.ops) / per, loop.fp32() / per, loop.count("MUFU") / per, loop)


def live_tiles(mask, b: int):
    """(B, T) bool: the tiles of ``fused_score.tile_maps`` that hold a live
    pair, one row per dataset of ``mask: (B, p)``. Off the diagonal a live
    pair needs a live row in each block; a diagonal tile needs two. The
    kernel writes zero partials for every other tile and stages none of its
    samples."""
    bsz, p = mask.shape
    nt = -(-p // b)
    blocks = torch.zeros((bsz, nt * b), dtype=torch.int64, device=mask.device)
    blocks[:, :p] = mask.to(torch.int64)
    live = blocks.reshape(bsz, nt, b).sum(dim=2)
    i, j = tile_maps(nt).long().to(mask.device)
    return torch.where(i == j, live[:, i] >= 2, (live[:, i] > 0) & (live[:, j] > 0))


def sweep_chunks(mask, n_valid, n: int, b: int) -> tuple[int, int]:
    """Sample chunks (``BLOCK_N`` samples of a tile) the sweep stages for
    ``mask: (B, p)`` and valid counts ``n_valid`` (None or (B,)), against
    those a sweep of every tile over the padded n would: ``(swept, padded)``."""
    nv = torch.full((mask.shape[0],), n) if n_valid is None else torch.as_tensor(n_valid)
    per_tile = (nv.clamp(0, n).cpu().long() + BLOCK_N - 1) // BLOCK_N
    live = live_tiles(mask, b).cpu()
    return int((live.sum(dim=1) * per_tile).sum()), live.numel() * (-(-n // BLOCK_N))
